"""Data-parallel execution over ``torch.distributed`` ranks (:mod:`.dp`)."""
