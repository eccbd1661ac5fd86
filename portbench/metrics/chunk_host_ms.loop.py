"""The host's part of the device loop's chunk gap (ms): the median of the
program's ``chunk.gap.host_sec`` (``"device"`` metrics), from the host
holding a chunk's rows to the next ``run_chunk`` (trial documents,
events, refresh, early stop, the next seed), when the card has nothing
queued.  The histogram keeps the newest 512 chunks, all from the
window's last searches.  None where the program does not count it."""


def read(art):
    from hyperopt_tpu_torch.obs import get_metrics

    h = get_metrics("device").snapshot()["metrics"].get("chunk.gap.host_sec")
    if not h or not h.get("count"):
        return None
    return 1e3 * h["p50"]
