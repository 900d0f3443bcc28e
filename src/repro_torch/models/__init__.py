"""repro_torch.models - the model zoo for the dense, moe, ssm, hybrid, vlm
and encdec families (port of ``repro.models``); see
:mod:`repro_torch.models.model_zoo`."""
