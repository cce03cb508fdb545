"""Host-side data pipeline of the port (a copy of ``scal_sdt_tpu/data``:
numpy batches, identical to the JAX package's for the same seed)."""

Size = tuple[int, int]
