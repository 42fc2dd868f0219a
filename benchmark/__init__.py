"""The benchmark of sparsex_tpu_torch (see README.md)."""
