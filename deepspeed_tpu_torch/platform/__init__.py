from .device import device_report, nvidia_smi_line, resolve_device

__all__ = ["device_report", "nvidia_smi_line", "resolve_device"]
