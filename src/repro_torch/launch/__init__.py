"""repro_torch.launch — launchable jobs of the port."""
