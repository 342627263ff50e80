"""The data path the Synergy iterator drives (a copy of ``repro.data``):
the MinIO cache model (``minio``) and the input pipeline (``pipeline``)."""
