"""Host-side CSX preprocessing: substructure mining, statistics, encoding
(the port's copy of ``sparsex_tpu/preprocess``)."""
