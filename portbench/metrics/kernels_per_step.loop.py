"""Kernels per TPE step of the device loop: the traced chunks' kernel
launches (copies and fills left out) over the TPE graph replays."""


def read(art):
    if not art.get("events") or not art.get("tpe_steps"):
        return None
    n = sum(1 for name, _, _ in art["events"] if not name.startswith(("Memcpy", "Memset")))
    return n / art["tpe_steps"]
