"""Domain model and pipeline stages: copies of the JAX package's host
models, and the stages that reach the device — tandem masking
(``mask``), pile-up collection with bubble re-mapping (``pileups``) and
pile-up processing (``process``)."""
