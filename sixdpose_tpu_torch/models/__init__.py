"""Model-level APIs: the template bank, the template-matching detector,
batched ICP and verification, and the fused detect -> refine -> verify
pipeline."""
