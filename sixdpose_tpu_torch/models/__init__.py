"""Model-level APIs: the template bank, the template-matching detector,
batched ICP and verification, the fused detect -> refine -> verify
pipeline, and render-based training."""
