"""launches_per_frame (launches): CUDA kernel launches in the traced
window (the frozen count_events over the runtime calls), over the frames
tracked in it."""


def read(rec: dict):
    t = rec.get("trace")
    if not t or not rec["frames"]:
        return None
    return t["counts"]["kernel_launches"] / rec["frames"]
