from repro_torch.kernels.bank_scan.ops import bank_scan
from repro_torch.kernels.bank_scan.ref import bank_scan_ref

__all__ = ["bank_scan", "bank_scan_ref"]
