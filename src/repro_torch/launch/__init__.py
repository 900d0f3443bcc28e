"""repro_torch.launch - the serving launcher (port of ``repro.launch.serve``)
and the config reduction it shares with the trainer, which waits."""
