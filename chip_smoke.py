#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (an H100 for sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``self_attention_tacotron_torch/ops/csrc``
(into ``build/torch_kernels/``), then, at the full widths of the shipped
VQ-code recipe (``examples/codes/self-attention-tacotron.json``) with
weights drawn from a seed:

1. prints the card (``nvidia-smi`` name and power limit) and CUDA version;
2. builds both kernels, one nvcc each, in parallel;
3. ``fused_encode``: kernel vs its plain PyTorch version, T = 64 phones,
   L = 64 and L = 50;
4. ``fused_decode``: kernel vs its plain version, 450 steps, early stop
   off; the code-argmax agreement; early stop on (equal lengths); a
   large-|v| case that must stay finite;
5. end to end: ``cli.predict.main_code`` serves a 3-utterance synthetic
   corpus from a seeded checkpoint on ``cuda``; the launch counters are
   zeroed just before and must both be > 0 just after;
6. times each kernel and its plain version with CUDA events (median of 5
   after a warm-up) and prints one JSON line of per-kernel numbers.

The last line is ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before it; so does a machine without CUDA, or a directory that
holds this script without the package.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RECIPE = os.path.join(ROOT, "examples", "codes", "self-attention-tacotron.json")
SEED = 0
T_IN = 64
# Tolerances (max abs error, kernel vs plain version, both float32, TF32
# off).  The encoder sums up to 6144 products per output in another order
# than the plain version's matmuls; the decoder feeds its own logits back
# for 450 steps, so summation-order differences compound along the chain.
# On an H100 the worst errors read 2.6e-8 (encoder) and 1.8e-7 (decode
# alignments) over every run; 1e-5 leaves ~50x room for summation order
# and still fails a kernel whose products drop to TF32 or bf16.
TOL_ENCODE = 1e-5
TOL_DECODE = 1e-5
# peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth, FP32 non-tensor
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def _max_err(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def _rel_err(a, b) -> float:
    return _max_err(a, b) / max(float(b.abs().max()), 1e-12)


def recipe_hparams():
    from self_attention_tacotron_torch.config import default_hparams
    return default_hparams().parse_json_file(RECIPE)


def make_model(hp, device):
    from self_attention_tacotron_torch.models import tacotron_model_factory
    from self_attention_tacotron_torch.utils.convert import init_parameters
    model = tacotron_model_factory(hp)
    init_parameters(model, SEED)
    return model.to(device).eval()


def source_ids(hp, length: int, T: int, seed: int, device):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    src = np.zeros((1, T), np.int64)
    src[0, :length] = rng.integers(1, hp.num_symbols, length)
    return torch.from_numpy(src).to(device)


def encoder_case(model, length: int, T: int, device):
    """(params, x, kwargs) of the fused encoder for a random source."""
    enc = model.encoder
    x = model.embedding(source_ids(model.hp, length, T, SEED + length, device))
    kw = dict(max_filter_width=enc.max_filter_width,
              conv_channels=enc.conv_channels, half=enc.cbhg_out_units // 2,
              sa_units=enc.self_attention_out_units,
              num_heads=enc.self_attention_num_heads,
              zoneout_cell=enc.zoneout_factor_cell,
              zoneout_output=enc.zoneout_factor_output)
    return enc.fused_params(), x, kw


def decoder_case(model, length: int, T: int, device):
    """(weights, memory, options) of the fused decode from the encoder's
    outputs (plain version) on a random source."""
    import torch
    from self_attention_tacotron_torch.ops import fused_encoder as fe
    params, x, kw = encoder_case(model, length, T, device)
    lstm_out, sa = fe.fused_encode_reference(params, x, length, **kw)
    lengths = torch.tensor([length], device=device)
    dec = model.decoder
    packs = tuple(m.precompute(s, lengths) for m, s in
                  zip(dec.attention_mechanisms, (lstm_out, sa)))
    return dec.fused_inputs(packs)


def phase_encode(model, device):
    """Kernel vs plain version; returns the worst max abs error."""
    import torch
    from self_attention_tacotron_torch.ops import fused_encoder as fe
    worst = 0.0
    for L in (T_IN, 50):
        params, x, kw = encoder_case(model, L, T_IN, device)
        got = fe.fused_encode(params, x, L, **kw)
        ref = fe.fused_encode_reference(params, x, L, **kw)
        if device.type == "cuda":
            torch.cuda.synchronize()
        errs = [(_max_err(g, r), _rel_err(g, r)) for g, r in zip(got, ref)]
        zero_tail = bool((got[0][0, L:] == 0).all())
        log(f"phase 3 fused_encode T={T_IN} L={L}: lstm_out abs "
            f"{errs[0][0]:.3e} rel {errs[0][1]:.3e}; sa_out abs "
            f"{errs[1][0]:.3e} rel {errs[1][1]:.3e}; zero past L: {zero_tail}")
        if max(e[0] for e in errs) > TOL_ENCODE or not zero_tail:
            raise AssertionError(f"fused_encode disagrees (tol {TOL_ENCODE})")
        worst = max(worst, *(e[0] for e in errs))
    return worst


def _decode_pair(weights, memory, options, steps):
    import torch
    from self_attention_tacotron_torch.ops import fused_decode as fd
    got = fd.fused_decode(weights, memory, num_steps=steps, **options)
    ref = fd.fused_decode_reference(weights, memory, num_steps=steps,
                                    **options)
    if memory.keys[0].is_cuda:
        torch.cuda.synchronize()
    return got, ref


def _post_hoc_length(stop, min_iters) -> int:
    import torch
    from self_attention_tacotron_torch.models.decoder import stop_lengths
    S = stop.shape[1]
    fired = (stop > 0) & (torch.arange(S, device=stop.device) > min_iters)
    return int(stop_lengths(torch.cumsum(fired.int(), 1) > 0)[0])


def phase_decode(model, device, steps: int):
    """Kernel vs plain version; returns the worst max abs error."""
    weights, memory, options = decoder_case(model, 50, T_IN, device)
    options = dict(options, early_stop=False)
    got, ref = _decode_pair(weights, memory, options, steps)
    errs = {"out": _max_err(got[0], ref[0]), "stop": _max_err(got[1], ref[1]),
            "aligns": max(_max_err(g, r) for g, r in zip(got[2], ref[2]))}
    agree = float((got[0].argmax(-1) == ref[0].argmax(-1)).float().mean())
    log(f"phase 4 fused_decode {steps} steps, early stop off: max abs err "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; code argmax agreement {agree:.4f}")
    if max(errs.values()) > TOL_DECODE or agree < 1.0:
        raise AssertionError(f"fused_decode disagrees (tol {TOL_DECODE})")

    # early stop on: a stop bias that fires right after min_iters
    head_b = weights.head_b.clone()
    head_b[weights.cr] += 5.0
    got_s, ref_s = _decode_pair(weights._replace(head_b=head_b), memory,
                                dict(options, early_stop=True), steps)
    n_got = _post_hoc_length(got_s[1], options["min_iters"])
    n_ref = _post_hoc_length(ref_s[1], options["min_iters"])
    err_s = _max_err(got_s[0], ref_s[0])
    tail_zero = bool((got_s[0][:, n_got:] == 0).all())
    log(f"phase 4 fused_decode early stop on: lengths kernel {n_got} plain "
        f"{n_ref}; out max abs err {err_s:.3e}; zero after exit {tail_zero}")
    if n_got != n_ref or err_s > TOL_DECODE or not tail_zero:
        raise AssertionError("early-stop decode disagrees")

    # |v| scaled so that sum|v| is far above the row max of the energies
    scale = 1e3
    got_v, ref_v = _decode_pair(weights._replace(v=weights.v * scale),
                                memory, options, steps)
    finite = all(bool(t.isfinite().all()) for t in (got_v[0], got_v[1],
                                                    *got_v[2]))
    log(f"phase 4 fused_decode |v| x{scale:g}: finite {finite}; out max abs "
        f"err vs plain {_max_err(got_v[0], ref_v[0]):.3e}")
    if not finite:
        raise AssertionError("large-|v| decode is not finite")
    return max(errs["out"], errs["stop"], errs["aligns"], err_s)


def write_corpus(hp, root: str, n: int = 3):
    """A synthetic codes corpus: phone-id sources and one-hot targets."""
    import numpy as np
    from self_attention_tacotron_torch.data.records import (
        CodeTargetRecord, SourceRecord, write_code_target_record,
        write_source_record)
    rng = np.random.default_rng(SEED)
    keys = []
    for i in range(n):
        key = f"utt{i:03d}"
        L = int(rng.integers(40, T_IN + 1))
        phone = rng.integers(1, hp.num_symbols, L).astype(np.int64)
        write_source_record(SourceRecord(
            id=i, key=key, source=phone, source_length=L, text=f"utt {i}",
            phone=phone, phone_length=L, phone_txt=" ".join(map(str, phone))),
            os.path.join(root, f"{key}.{hp.source_file_extension}"),
            with_phone=True)
        n_codes = int(rng.integers(50, 120))
        codes = np.eye(hp.num_mels, dtype=np.float32)[
            rng.integers(0, hp.num_mels, n_codes)]
        write_code_target_record(CodeTargetRecord(
            id=i, key=key, lang="", codes=codes, codes_length=n_codes,
            codes_width=hp.num_mels),
            os.path.join(root, f"{key}.{hp.target_file_extension}"))
        keys.append(key)
    with open(os.path.join(root, "test.csv"), "w") as f:
        f.write("\n".join(keys) + "\n")
    return keys


def phase_end_to_end(model, device_name: str):
    """main_code on a synthetic corpus; returns the launch counts."""
    import numpy as np
    from self_attention_tacotron_torch.cli.predict import main_code
    from self_attention_tacotron_torch.data.records import (
        parse_prediction_record, read_first_example)
    from self_attention_tacotron_torch.ops import fused_decode as fd
    from self_attention_tacotron_torch.ops import fused_encoder as fe
    from self_attention_tacotron_torch.utils.convert import save_checkpoint
    hp = model.hp
    with tempfile.TemporaryDirectory() as tmp:
        data, ckpt, out = (os.path.join(tmp, d) for d in ("data", "ckpt",
                                                          "out"))
        os.makedirs(data)
        keys = write_corpus(hp, data)
        save_checkpoint(model, ckpt, step=1)
        fe.fused_encode.launches = 0
        fd.fused_decode.launches = 0
        rc = main_code(["--source-data-root", data, "--target-data-root", data,
                        "--checkpoint-dir", ckpt, "--output-dir", out,
                        "--hparam-json-file", RECIPE,
                        "--device", device_name])
        counts = {"fused_encode": fe.fused_encode.launches,
                  "fused_decode": fd.fused_decode.launches}
        if rc != 0:
            raise AssertionError(f"main_code returned {rc}")
        for key in keys:
            rec = parse_prediction_record(
                read_first_example(os.path.join(out, f"{key}.tfrecord")))
            dump = np.fromfile(os.path.join(
                out, f"{key}.{hp.predicted_mel_extension}"), "<f4")
            if (rec.codes.shape[1] != hp.num_mels or rec.codes.shape[0] < 1
                    or dump.size != rec.codes.size
                    or not np.array_equal(rec.codes.sum(1),
                                          np.ones(rec.codes.shape[0]))):
                raise AssertionError(f"bad prediction files for {key}")
    log(f"phase 5 end to end: main_code served {len(keys)} utterances on "
        f"{device_name}; launch counts {counts}")
    if device_name == "cuda" and min(counts.values()) < 1:
        raise AssertionError("a kernel of the main path never launched")
    return counts


def _time_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` of one call, CUDA events, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def encode_bound(params, x, kw):
    """(bytes, FLOPs) the encoder function needs at this input (L = T):
    every weight read once and applied to every row, x read, the outputs
    written.  The conv bank counts width k's k taps (E * C * k weights),
    not the zero blocks of the kernel's stacked (K*E, K*C) bank."""
    T = x.shape[1]
    H, SA, K = kw["half"], kw["sa_units"], kw["max_filter_width"]
    w_bank, b_bank = params.w_bank
    bank_taps = (w_bank.shape[0] // K) * kw["conv_channels"] * K * (K + 1) // 2
    weights = T * bank_taps      # weight floats times the rows they meet
    tensors = [x, b_bank]
    mats = [*params.prenet, params.w_proj1, params.w_proj2, *params.highway,
            params.sa_proj]
    if params.w_adjust is not None:
        mats.append(params.w_adjust)
    mats += [(w, b) for w_kvq, b_kvq, w_ot, b_ot in params.hops
             for w, b in ((w_kvq, b_kvq), (w_ot, b_ot))]
    for w, b in mats:
        tensors += [w, b]
        weights += T * w.numel()
    wx, wh_t, b_lstm = params.lstm
    tensors += [wx, wh_t, b_lstm]
    weights += T * (wx.numel() + wh_t.numel())
    flops = 2 * weights + len(params.hops) * 4 * T * T * SA
    out_bytes = 4 * T * (2 * H + SA)
    return _nbytes(tensors) + 4 * bank_taps + out_bytes, flops


def decode_bound(params, w, memory, steps: int):
    """(bytes, FLOPs) of ``steps`` decode steps: each product counted in
    the cheaper of its two exact forms, the decoder's own (``params``) or
    the kernel's merged one (``w``), with every weight of that form read
    once and used once a step, the memory read once and the outputs
    written.  The merges win for the next prenet input (y @ (W_fb @ W0)
    rather than frame @ W0) and Wo @ Wt; the module's form wins for
    outproj + lstm1 (the merged one carries Wop @ W1x and a zero block)
    and for the location conv and dense."""
    T = memory.keys[0].shape[1]
    D = w.l2_b.shape[0] // 4
    P0 = w.p0_init.shape[0]
    c_total = sum(v.shape[2] for v in memory.values)
    W0 = params.prenet[0][0]
    # weights applied once a step (one multiply-add per weight)
    dense = min(W0.numel(), D * P0)                   # next prenet input
    dense += sum(m.numel() for m, _ in params.prenet[1:])
    dense += params.att_lstm[0].numel()
    dense += sum(wq.numel() for wq, _ in params.query)
    dense += min(params.outproj[0].numel() + params.lstm1[0].numel(),
                 w.big_w.numel() - D * D)
    dense += params.lstm2[0].numel() + params.head[0].numel()
    for wk, _, wv, _, wq, _, wo, _, wt, _ in params.hops:
        dense += wk.numel() + wv.numel() + wq.numel()
        dense += min(wo.numel() + wt.numel(), D * D)
    # location weights, applied at each of the T memory steps
    loc = sum(min(l[0].numel() + l[2].numel(), w.loc_kernel * u)
              for l, u in zip(params.loc, w.u_sizes) if l is not None)
    per_step = dense + T * (loc + sum(w.u_sizes) + c_total)
    flops = 2 * steps * per_step \
        + len(w.hops) * 4 * D * steps * (steps + 1) // 2
    vecs = [w.p0_init, w.att_b, w.v, w.key_fold, w.big_b, w.l2_b, w.head_b,
            *(b for _, b in w.prenet),
            *(t for hop in w.hops for t in (hop[1], hop[3]))]
    mem = [*memory.keys, *memory.values, *memory.masks]
    out_bytes = 4 * steps * (w.cr + 1 + len(w.kinds) * T)
    return 4 * (dense + loc) + _nbytes(vecs + mem) + out_bytes, flops


def _stage_shares(name, launch, stages, ms: float, per: int, unit: str):
    """One profiled launch: each stage's share of block 0's SM cycles, and
    that share of the kernel's measured time ``ms`` per ``unit``."""
    import torch
    launch()
    torch.cuda.synchronize()
    cycles = launch.stage_cycles.cpu().tolist()
    total = max(sum(cycles), 1)
    parts = ", ".join(
        f"{stage} {100.0 * c / total:.1f}% ({ms * 1e3 * c / total / per:.3f}"
        f" us/{unit})" for stage, c in zip(stages, cycles) if c)
    log(f"phase 6 {name} stages (block 0 cycles between grid barriers, as a"
        f" share of {ms:.4f} ms): {parts}")


def phase_timing(model, device, steps: int, launches, errs):
    from self_attention_tacotron_torch.ops import fused_decode as fd
    from self_attention_tacotron_torch.ops import fused_encoder as fe
    params, x, kw = encoder_case(model, T_IN, T_IN, device)
    enc_launch = fe.prepare_encode(params, x, T_IN, **kw)
    enc_ms = _time_ms(enc_launch)
    enc_plain = _time_ms(lambda: fe.fused_encode_reference(params, x, T_IN,
                                                           **kw))
    weights, memory, options = decoder_case(model, T_IN, T_IN, device)
    options = dict(options, early_stop=False)
    dec_launch = fd.prepare_decode(weights, memory, num_steps=steps,
                                   **options)
    dec_ms = _time_ms(dec_launch)
    dec_plain = _time_ms(lambda: fd.fused_decode_reference(
        weights, memory, num_steps=steps, **options), reps=3)
    frames = steps * model.hp.outputs_per_step
    log(f"phase 6 timing: fused_encode {enc_ms:.4f} ms (plain "
        f"{enc_plain:.4f} ms); fused_decode {steps} steps {dec_ms:.4f} ms "
        f"(plain {dec_plain:.4f} ms); {frames / ((enc_ms + dec_ms) / 1e3):.1f}"
        f" frames/s kernel, {frames / ((enc_plain + dec_plain) / 1e3):.1f} "
        "frames/s plain")
    _stage_shares("fused_encode", fe.prepare_encode(params, x, T_IN, **kw,
                                                    profile=True),
                  fe.ENC_STAGES, enc_ms, 1, "call")
    _stage_shares("fused_decode", fd.prepare_decode(
        weights, memory, num_steps=steps, **options, profile=True),
        fd.DEC_STAGES, dec_ms, steps, "step")
    log(f"launch counts of the main path: fused_encode="
        f"{launches['fused_encode']} fused_decode={launches['fused_decode']}")
    rows = []
    bounds = {"fused_encode": encode_bound(params, x, kw),
              "fused_decode": decode_bound(model.decoder.fused_params(),
                                           weights, memory, steps)}
    log("phase 6 bound inputs: " + "; ".join(
        f"{k} {b[0]} bytes, {b[1]} FLOPs" for k, b in bounds.items()))
    for name, src, line, ms, plain, (nbytes, flops) in (
            ("fused_encode", "fused_encoder", 94, enc_ms, enc_plain,
             bounds["fused_encode"]),
            ("fused_decode", "fused_decode", 250, dec_ms, dec_plain,
             bounds["fused_decode"])):
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": f"self_attention_tacotron_torch/ops/csrc/{src}.cu",
            "replaces": f"self_attention_tacotron_tpu/ops/{src}.py:{line}",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
    print(json.dumps({"kernels": rows}), flush=True)


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is missing: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from self_attention_tacotron_torch.ops import cuda_build
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    device = torch.device("cuda", 0)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        log(f"phase 1 card: {smi[0] if smi else 'nvidia-smi gave nothing'}"
            f"; torch {torch.__version__} CUDA {torch.version.cuda}")
        log(smi[0] if smi else torch.cuda.get_device_name(0))

        t0 = time.perf_counter()
        logs = cuda_build.build_all(["fused_encoder", "fused_decode"])
        log(f"phase 2 built fused_encoder, fused_decode in "
            f"{time.perf_counter() - t0:.1f} s")
        for name, text in logs.items():
            for line in text.splitlines():
                if "registers" in line or "smem" in line:
                    log(f"  ptxas {name}: {line.strip()}")

        hp = recipe_hparams()
        model = make_model(hp, device)
        steps = hp.max_iters
        errs = {"fused_encode": phase_encode(model, device),
                "fused_decode": phase_decode(model, device, steps)}
        launches = phase_end_to_end(model, "cuda")
        phase_timing(model, device, steps, launches, errs)
    except Exception as e:  # noqa: BLE001 - every phase failure ends here
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
