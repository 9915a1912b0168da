"""Launchers of the port.  Importing ``repro_torch.launch.kernel`` registers
the ``device-kernel`` executor."""
