"""Launchers of the port.  Importing ``repro_torch.launch.kernel`` registers
the ``device-kernel`` executor; ``repro_torch.launch.serve`` (the token-loop
decode launcher) registers ``conf-target``, ``decode`` and ``token-loop``."""
