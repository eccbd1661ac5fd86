"""Mean wall time (ms) of the driver's ``propose`` spans over the traced
search's TPE generations (the port's span JSONL; the span ends once the
proposals are on the host)."""


def read(art):
    spans = [r for r in art.get("spans", ()) if r.get("name") == "propose"
             and int(r.get("attrs", {}).get("gen", -1)) * art["batch"] >= art["n_startup"]]
    if not spans:
        return None
    return 1e3 * sum(r["wall_sec"] for r in spans) / len(spans)
