"""Runtime debugging aids for the fabric (see ``repro_torch.debug.sanitize``)."""
