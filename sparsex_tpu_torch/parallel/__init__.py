"""Row partitioning (the port's copy of ``sparsex_tpu/parallel``)."""
