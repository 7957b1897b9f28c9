"""The attention keys of both sources (each mechanism's ``memory_layer``),
which the model computes in plain PyTorch before the decode loop: one
product a source over its T positions.  No hand-written kernel computes
them, so this count lists no symbols; it counts toward the call's model
FLOPs (``mfu_pct``) and not toward any kernel's roofline.
"""

SYMBOLS = ()
OPERANDS = "f32"
LIBRARY = None
COUNTER = None


def count(hp: dict, call: dict):
    """(bytes, FLOPs) of both sources' key products for ``call["T"]``
    positions and ``call["rows"]`` rows."""
    T, B = call["T"], call["rows"]
    pairs = [(hp["cbhg_out_units"], hp["attention1_out_units"]),
             (hp["self_attention_out_units"], hp["attention2_out_units"])]
    flops = sum(2 * B * T * c * u for c, u in pairs)
    floats = sum(B * T * c + c * u + B * T * u for c, u in pairs)
    return 4 * floats, flops
