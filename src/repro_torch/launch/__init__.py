"""repro_torch.launch - the serving launcher (port of ``repro.launch.serve``)
and the training launcher (port of ``repro.launch.train``)."""
