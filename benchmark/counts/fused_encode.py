"""Kernel #1, the batch-1 serving encoder (``ops/fused_encoder.py``): the
operations and bytes of the encoder function itself at one call's source
length T, from the configuration's widths.

Every weight is read once and applied to every row; the embedded source is
read and the two outputs (bi-LSTM and hop) written once.  The conv bank
counts width k's k taps (E * C * k weights); the hop counts its K|V|Q
product and its output and transform denses as the one product Wo @ Wt
(the cheaper of the two exact forms); the hop's scores and context 4 T^2
SA.  These are the counts ``chip_smoke.py`` logged for this kernel, frozen
here as functions of the widths so that they read the same whatever
implements the encoder.
"""

SYMBOLS = ("encoder_trunk_kernel", "encoder_rnn_kernel")
OPERANDS = "f32"
# the program's library that holds the kernels, and their launch counter
LIBRARY = "fused_encoder"
COUNTER = ("self_attention_tacotron_torch.ops.fused_encoder",
           "fused_encode")


def count(hp: dict, call: dict):
    """(bytes, FLOPs) of one call: ``call["T"]`` source positions."""
    T = call["T"]
    widths = [hp["embedding_dim"], *hp["encoder_prenet_out_units"]]
    E = widths[-1]
    K, C = hp["max_filter_width"], hp["conv_channels"]
    p1, p2 = hp["projection1_out_channels"], hp["projection2_out_channels"]
    H = hp["cbhg_out_units"] // 2
    SA = hp["self_attention_out_units"]
    hops = hp["self_attention_num_hop"]
    mats = [(i * o, o) for i, o in zip(widths, widths[1:])]
    mats += [(K * C * 3 * p1, p1), (p1 * 3 * p2, p2)]
    mats += [(H * 2 * H, 2 * H)] * hp["num_highway"]
    mats += [(2 * H * SA, SA)]
    if p2 != H:
        mats += [(p2 * H, H)]
    mats += [(SA * 3 * SA, 3 * SA), (SA * SA, SA)] * hops
    lstm_w = 2 * H * 4 * H + 2 * 4 * H * H
    bank_taps = E * C * K * (K + 1) // 2
    weights = T * (bank_taps + sum(w for w, _ in mats) + lstm_w)
    flops = 2 * weights + hops * 4 * T * T * SA
    floats = (T * widths[0] + K * C + sum(w + b for w, b in mats) + lstm_w
              + 2 * 4 * H + bank_taps + T * (2 * H + SA))
    return 4 * floats, flops
