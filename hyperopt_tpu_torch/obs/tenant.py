"""Tenant ids (counterpart of the id helpers of
``hyperopt_tpu/obs/tenant.py``, copied: host-only).  The server and the
client validate the ``x-tenant`` header with them; the tenant ledger,
its weighted-fair packer and its SLO objectives come with ROADMAP.md,
queue 1, item 14, and a request naming a tenant other than ``anon``
raises ``not_ported(..., 14)`` at the server until then."""

from __future__ import annotations

__all__ = ["ANON", "OTHER", "MAX_TENANT_LEN", "sanitize_tenant"]

#: the default principal: requests and studies that never named one
ANON = "anon"

#: the roll-up bucket of the JAX package's ledger, reserved
OTHER = "other"

#: hard length bound on a tenant id
MAX_TENANT_LEN = 128


def sanitize_tenant(value, default=ANON):
    """Validate one tenant id and return its canonical string, or raise
    ``ValueError`` (the HTTP layer answers 400).  ``None`` and ``""`` give
    ``default``; an id must be a ``str`` of at most
    :data:`MAX_TENANT_LEN` characters with no control bytes, and not the
    reserved ``other``."""
    if value is None:
        return default
    if not isinstance(value, str):
        raise ValueError(f"tenant id must be a string, got {type(value).__name__}")
    if value == "":
        return default
    if len(value) > MAX_TENANT_LEN:
        raise ValueError(f"tenant id too long ({len(value)} > {MAX_TENANT_LEN})")
    for ch in value:
        o = ord(ch)
        if o < 32 or o == 127:
            raise ValueError(f"tenant id contains control byte 0x{o:02x}")
    if value == OTHER:
        raise ValueError(f"tenant id {OTHER!r} is reserved for the roll-up bucket")
    return value
