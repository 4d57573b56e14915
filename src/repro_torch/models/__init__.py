"""repro_torch.models — the LM stack's models: the dense decoder-only
transformer (prefill and decode) and its building blocks, behind the
family dispatch of :mod:`repro_torch.models.model_api`."""
