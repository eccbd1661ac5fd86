"""The device loop's replay share (%) of a chunk cycle: 100 × the median
``chunk.span_sec`` (first graph replay's start to last replay's end) over
the medians of ``chunk.gap_sec`` and ``chunk.span_sec`` together, from
the program's ``"device"`` metrics on the card's clock, over the newest
512 chunks of the window.  None where the program does not count them."""


def read(art):
    from hyperopt_tpu_torch.obs import get_metrics

    m = get_metrics("device").snapshot()["metrics"]
    span, gap = m.get("chunk.span_sec"), m.get("chunk.gap_sec")
    if not span or not gap or not span.get("count") or not gap.get("count"):
        return None
    return 100.0 * span["p50"] / (gap["p50"] + span["p50"])
