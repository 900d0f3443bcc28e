"""repro_torch.core - the codesign planners (port of ``repro.core.codesign``)."""
