"""Pipeline stages that reach the device: tandem masking, pile-up
collection (bubble re-mapping) and pile-up processing (consensus)."""
