"""CVS data generation, configs, transforms and split helpers."""
