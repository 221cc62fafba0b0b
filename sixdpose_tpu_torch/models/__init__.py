"""Model-level APIs: the template bank and the template-matching detector."""
