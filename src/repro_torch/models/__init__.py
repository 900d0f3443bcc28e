"""repro_torch.models - the model zoo for the dense, ssm and hybrid
families (port of ``repro.models``); see :mod:`repro_torch.models.model_zoo`."""
