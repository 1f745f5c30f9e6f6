"""Row 1, ``stream_scatter`` (``csrc/stream_scatter.cu``): the segment sums
of a GATv1 training step's backward over the receiver stream, two a
layer: per receiver the logit cotangents [E_s, H], per sender (through the
CSC stream's slot map) the message cotangents [E_s, HF].

Bytes of a call, as ``chip_smoke.py`` bounds row 1: the live slots' data
once, the walk's index words (the receiver side's local row a slot and
tile a chunk; the sender side's the same over the CSC stream, and its slot
map), the [N_pad, L] sums written."""

TRACE = r"\btile_sum_kernel<[^>]*\bfloat\s*>"
AFTER = r"\btile_combine_kernel\b"  # its split tiles' combine
COUNTER = "stream_scatter"
SHARES = ("banded_sender_sum",)  # the same segment-sum body, f32


def calls(shapes: dict) -> list[float]:
    if shapes["order"] != "stream" or shapes.get("v2"):
        return []
    out = []
    for ps in shapes["passes"]:
        if not ps["train"]:
            continue
        n, live = ps["n_pad"], ps["e_real"]
        for lay in shapes["layers"]:
            h, f = lay["heads"], lay["f_out"]
            out.append(4 * live * h + 4 * (ps["e_s"] + ps["c"] + n * h))
            out.append(4 * live * h * f
                       + 4 * (2 * ps["e_s2"] + ps["c2"] + n * h * f))
    return out
