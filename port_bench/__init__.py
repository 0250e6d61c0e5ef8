"""The port's benchmark: ``python3 port_bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (``harness.py`` says how it is driven by data)."""
