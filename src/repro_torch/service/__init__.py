"""repro_torch.service — the streaming labeler of the clustering service."""
