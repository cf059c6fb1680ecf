"""Compatibility shim: the request model lives in repro_torch.core.request
(the scheduler is part of the paper's core and owns it). All in-repo call
sites import repro_torch.core.request directly; this re-export stays for
external users."""
from repro_torch.core.request import Request, ReqState  # noqa: F401

__all__ = ["Request", "ReqState"]
