"""Kernel #2, the whole autoregressive decode loop (``ops/fused_decode.py``):
the operations and bytes of the decoder's steps at one call's source
length T and steps run, from the configuration's widths.

Per step and row, each product in the cheaper of its two exact forms: the
next prenet input as y @ (W_fb @ W0) or frame @ W0, the output projection
and lstm1 as the module's two products or the one merged product, the hop's
output and transform denses as Wo @ Wt, the location conv and dense as
their product or the conv then the dense; each weight read once and used
once a step; the attention over every source position a step (location
taps, energy, context); the hop's scores and context over the growing
cache (4 D (t + 1) at step t).  Bytes: the weights, bias rows, keys,
values, masks and the speaker row read once; the outputs, the stop logits
and (at B = 1) the source alignments written once.  These are the counts
``chip_smoke.py`` logged for this kernel, frozen here as functions of the
widths so that they read the same whatever implements the decoder.
"""

SYMBOLS = ("fused_decode_kernel",)
OPERANDS = "f32"
# the program's library that holds the kernel, and its launch counter
# (module, function whose ``launches`` counts the calls it served)
LIBRARY = "fused_decode"
COUNTER = ("self_attention_tacotron_torch.ops.fused_decode",
           "fused_decode")

_LOCATION = ("forward", "location_sensitive")


def count(hp: dict, call: dict):
    """(bytes, FLOPs) of one call: ``call["T"]`` positions in each of the
    two sources, ``call["steps"]`` steps, ``call["rows"]`` rows."""
    T, S, B = call["T"], call["steps"], call["rows"]
    Cf = hp["num_mels"] * hp["n_feed_frame"]
    Cr = hp["num_mels"] * hp["outputs_per_step"]
    pw = list(hp["decoder_prenet_out_units"])
    P0 = pw[0]
    speaker = bool(hp["use_speaker_embedding"] and
                   hp["speaker_embedd_to_prenet"])
    layers = [(P0, P0)] if speaker else []
    layers += list(zip(pw, pw[1:]))
    sources = [(hp["cbhg_out_units"], hp["attention1_out_units"],
                hp["attention"]),
               (hp["self_attention_out_units"], hp["attention2_out_units"],
                hp["attention2"])]
    Cctx = sum(c for c, _, _ in sources)
    A, D = hp["attention_out_units"], hp["decoder_out_units"]
    hops = hp["decoder_self_attention_num_hop"]
    K, F = hp["attention_kernel"], hp["attention_filters"]
    dense = min(Cf * P0, D * P0)
    dense += sum(i * o for i, o in layers)
    dense += (pw[-1] + Cctx + A) * 4 * A
    dense += sum(A * u for _, u, _ in sources)
    dense += min((A + Cctx) * D + 2 * D * 4 * D,
                 5 * D * (A + Cctx + D) - D * D)
    dense += 2 * D * 4 * D + D * (Cr + 1)
    dense += hops * (3 * D * D + min(2 * D * D, D * D))
    locs = [min(K * F + F * u, K * u) if kind in _LOCATION else 0
            for _, u, kind in sources]
    per_step = dense + sum(T * (loc + u + c)
                           for loc, (c, u, _) in zip(locs, sources))
    flops = B * (2 * S * per_step + hops * 4 * D * S * (S + 1) // 2)
    sum_u = sum(u for _, u, _ in sources)
    vecs = (P0 + 4 * A + 2 * sum_u + 5 * D + 4 * D + Cr + 1 + P0
            + sum(o for _, o in layers) + hops * 4 * D)
    mem = 4 * B * T * sum(u + c for c, u, _ in sources) + B * 2 * T
    if speaker:
        flops += S * B * P0
        mem += 4 * B * P0
    out = 4 * S * (B * (Cr + 1) + (2 * T if B == 1 else 0))
    return 4 * (dense + sum(locs) + vecs) + mem + out, flops
