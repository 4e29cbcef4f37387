"""extract_windows_roofline (%): the hand-written window kernel
(kernels/csrc/extract_windows.cu, via ops/patches.extract_windows_levels)
against its byte bound: the bytes the frozen window_bytes counts for the
arguments of every call in the traced window, at the card's published
HBM bandwidth (peaks.json), over the kernel's device seconds in the
trace. Nothing when the trace holds no such kernel or the card is not in
the table."""


def read(rec: dict):
    t = rec.get("trace")
    peak = rec["peaks"].get(rec["device"]["kind"], {}).get("hbm_bytes_per_s")
    if not t or not peak:
        return None
    k = t["extract_windows"]
    if not k["kernels"] or not k["bytes"] or k["kernel_s"] <= 0:
        return None
    return 100.0 * k["bytes"] / peak / k["kernel_s"]
