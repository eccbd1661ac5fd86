"""The device loop's chunk gap (ms): the median of the program's
``chunk.gap_sec`` (``"device"`` metrics), from one chunk's last graph
replay to the next chunk's first on the card's clock.  The histogram
keeps the newest 512 chunks, all from the window's last searches: the
warm-up's captures and the traced search are left out.  None where the
program does not count it."""


def read(art):
    from hyperopt_tpu_torch.obs import get_metrics

    h = get_metrics("device").snapshot()["metrics"].get("chunk.gap_sec")
    if not h or not h.get("count"):
        return None
    return 1e3 * h["p50"]
