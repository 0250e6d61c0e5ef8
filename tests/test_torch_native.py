"""The PyTorch port's ctypes loader for the repo's C++ host library
(``structured_latent_odes_tpu_torch/native``), on the CPU: its parse of each
of the six proc files equals the port's ``csv`` parse and the JAX package's
native parse in every element (equal dtypes), its packer equals the numpy
gather with zero rows for negative entries, ``build_splits`` is equal with
and without the library, the library lands in ``build/native/`` (not the
JAX package's ``native/build/``), and several processes building it at once
each load a whole library."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from structured_latent_odes_tpu import native as jax_native
from structured_latent_odes_tpu_torch import native
from structured_latent_odes_tpu_torch.data import configs, proc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROC_FILES = configs.proc_data_config().files


@pytest.fixture(scope="module")
def lib():
    if native.compiler() is None:
        pytest.skip("no C++ compiler on PATH")
    native.build()  # raises with the compiler's output if the build fails
    assert native.lib() is not None
    return native.lib()


def _assert_arrays(ours, ref, where):
    assert len(ours) == len(ref), where
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert a.dtype == b.dtype and a.shape == b.shape, (where, i, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f"{where}[{i}]")


@pytest.mark.parametrize("name", PROC_FILES)
def test_native_parse_matches_csv_and_jax(lib, name):
    data = configs.load_proc_config().data
    path = os.path.join(configs.load_proc_config().data_path, name)
    ours = native.parse_proc_csv_native(path, data.devices, data.conditions, data.signals)
    assert ours is not None
    ref = jax_native.parse_proc_csv_native(path, data.devices, data.conditions, data.signals)
    if ref is not None:  # the JAX package's library built
        _assert_arrays(ours, ref, f"{name} vs JAX native")
    _assert_arrays(proc.parse_file(path, data), proc.parse_file(path, data, use_native=False), f"{name} vs csv")


@pytest.mark.parametrize("shape", [(6, 4), (9, 3, 5), (5,)])
def test_pack_matches_numpy_gather(lib, shape):
    src = np.random.RandomState(0).randn(*shape).astype(np.float32)
    perm = np.array([3, 1, -1, 4, 0, -7, 2], dtype=np.int32)
    ref = np.where((perm >= 0).reshape((-1,) + (1,) * (src.ndim - 1)), src[np.maximum(perm, 0)], 0.0)
    out = native.pack_epoch_native(src, perm, len(perm))
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)
    with pytest.raises(ValueError, match="perm"):
        native.pack_epoch_native(src, perm, len(perm) + 1)


def test_build_splits_equal_with_and_without_the_library(lib, monkeypatch):
    from structured_latent_odes_tpu_torch.data.loader import stacked_minibatches

    config = configs.load_proc_config()
    with_lib, times = proc.build_splits(config)
    packed = stacked_minibatches(with_lib["train"], 36, shuffle=True, rng=np.random.RandomState(3))
    monkeypatch.setattr(native, "_lib", None)  # lib() now returns None: the csv parse, the numpy gather
    assert native.lib() is None
    without, times2 = proc.build_splits(config)
    gathered = stacked_minibatches(without["train"], 36, shuffle=True, rng=np.random.RandomState(3))
    np.testing.assert_array_equal(times, times2)
    for name in with_lib:
        for k in with_lib[name]:
            _assert_arrays([with_lib[name][k]], [without[name][k]], f"{name}.{k}")
    for k in packed:
        _assert_arrays([packed[k]], [gathered[k]], f"stacked {k}")


def test_library_lands_in_build_native(lib):
    assert native.LIBRARY == os.path.join(REPO, "build", "native", "libslode_native.so")
    assert os.path.exists(native.LIBRARY) and lib._name == native.LIBRARY
    assert not native.LIBRARY.startswith(os.path.join(REPO, "native") + os.sep)


_BUILD_AND_PACK = textwrap.dedent(
    """
    import sys
    import numpy as np
    from structured_latent_odes_tpu_torch import native
    native.LIBRARY = sys.argv[1]
    native.build()
    assert native.lib() is not None
    src = np.arange(4, dtype=np.float32).reshape(2, 2)
    print(native.pack_epoch_native(src, np.array([1, -1], np.int32), 2).tolist())
    """
)


def test_concurrent_builds_each_load_a_whole_library(lib, tmp_path):
    """Six processes build one library path at once: each compiles to a name
    of its own and moves it into place, so each loads a whole library and no
    temporary file is left."""
    target = str(tmp_path / "lib" / "libslode_native.so")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_PACK, target], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env={**os.environ, "PYTHONPATH": REPO})
             for _ in range(6)]
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
        assert out.strip() == "[[2.0, 3.0], [0.0, 0.0]]"
    assert os.listdir(tmp_path / "lib") == ["libslode_native.so"]
