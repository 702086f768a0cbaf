"""Dense decoder model (attention-only blocks) in PyTorch."""
