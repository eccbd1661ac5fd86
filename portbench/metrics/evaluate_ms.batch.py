"""Mean wall time (ms) of the driver's ``evaluate`` spans (the host
objective over a generation's trials) in the traced search."""


def read(art):
    spans = [r for r in art.get("spans", ()) if r.get("name") == "evaluate"]
    if not spans:
        return None
    return 1e3 * sum(r["wall_sec"] for r in spans) / len(spans)
