"""Row 2, ``fused_v1`` (``csrc/fused_v1.cu``): the fused GATv1 attention
forward over the receiver stream, once per layer in each forward pass (a
training step's and each validation forward).

Bytes of a call, as ``chip_smoke.py`` bounds row 2: the sender table wh
[N_pad, HF] once; f_dst and bound [N_pad, H]; a [H, F]; the keep factors
of the live slots [E_live, H]; the index words (senders and r_local a
stream slot, r_chunk a chunk); out [N_pad, HF] and den [N_pad, H]
written."""

TRACE = (r"\btile_fused_kernel<\s*\d+\s*,\s*\w+\s*,\s*false\s*,\s*\w+\s*,\s*"
         r"(?:\(anonymous namespace\)::)?ListWalk\b")
AFTER = r"\btile_combine_kernel\b"  # its split tiles' combine
COUNTER = "fused_v1"
SHARES = ()


def calls(shapes: dict) -> list[float]:
    if shapes["order"] != "stream" or shapes.get("v2"):
        return []
    out = []
    for ps in shapes["passes"]:
        n, e_s, c, live = ps["n_pad"], ps["e_s"], ps["c"], ps["e_real"]
        for lay in shapes["layers"]:
            h, f = lay["heads"], lay["f_out"]
            out.append(4 * n * h * f + 4 * (2 * n * h + h * f + live * h
                                            + 2 * e_s + c
                                            + n * (h * f + h)))
    return out
