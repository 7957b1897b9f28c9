"""Hyperparameters of the PyTorch port: a copy of the JAX package's
``config.py`` (the port imports nothing from that package).

Capability parity with the reference's flat ``tf.contrib.training.HParams``
namespace (reference: hparams.py:11-225) and its layered override scheme
(defaults -> ``--hparam-json-file`` JSON -> ``--hparams`` comma string,
reference: train.py:110-115).  Key names are kept identical so the example
JSON configs (``examples/*/*.json``) load unchanged; the kernel toggles
(``encoder_fused_inference``, ``decoder_fused_inference``) select the
hand-written CUDA kernels in the port.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple


def _list_f(*xs: float) -> Any:
    return field(default_factory=lambda: list(xs))


@dataclass(eq=False)  # eq=False keeps identity hashing (usable as a static
class HParams:        # attribute of flax modules / jit closures)
    # ------------------------------------------------------------------ Audio
    num_mels: int = 1025
    num_mgcs: int = 60
    num_freq: int = 2049
    sample_rate: int = 48000
    frame_length_ms: float = 50.0
    frame_shift_ms: float = 12.5
    ref_level_db: float = 20
    average_mel_level_db: List[float] = _list_f(0.0)
    stddev_mel_level_db: List[float] = _list_f(0.0)
    min_mel_level_db: List[float] = _list_f(0.0)
    # emitted by our corpus-statistics reduction alongside the reference's
    # avg/stddev/min (reference: preprocess_vctk.py:84-86) so the whole
    # emitted hparams.json can be merged into a model config verbatim
    max_mel_level_db: List[float] = _list_f(0.0)
    silence_mel_level_db: float = -3.0

    # MGC
    mgc_dim: int = 60
    mgc_alpha: float = 0.77
    mgc_gamma: float = 0.0
    mgc_fft_len: int = 4096

    # LF0
    num_lf0s: int = 256
    f0_max: float = 529.0
    f0_min: float = 66.0
    lf0_loss_factor: float = 0.5

    # ---------------------------------------------------------------- Dataset
    dataset: str = "codes.dataset.DatasetSource"
    num_symbols: int = 256
    source: str = "phone"  # phone | phoneme | (anything else -> character ids)
    source_file_extension: str = "source.tfrecord"
    target_file_extension: str = "target.tfrecord"

    # ------------------------------------------------------------------ Model
    tacotron_model: str = "DualSourceSelfAttentionTacotronModel"
    outputs_per_step: int = 1
    n_feed_frame: int = 1

    # Embedding
    embedding_dim: int = 256

    # accent
    use_accent_type: bool = False
    accent_type_embedding_dim: int = 32
    num_accent_type: int = 129
    accent_type_offset: int = 0x3100
    accent_type_unknown: int = 0x3180
    accent_type_prenet_out_units: Tuple[int, ...] = (32, 16)
    encoder_prenet_out_units_if_accent: Tuple[int, ...] = (224, 112)

    # Encoder
    encoder: str = "SelfAttentionCBHGEncoder"

    # Encoder V1
    encoder_prenet_drop_rate: float = 0.5
    cbhg_out_units: int = 256
    conv_channels: int = 128
    max_filter_width: int = 16
    projection1_out_channels: int = 128
    projection2_out_channels: int = 128
    num_highway: int = 4
    encoder_prenet_out_units: Tuple[int, ...] = (256, 128)

    # Encoder V2
    encoder_v2_num_conv_layers: int = 3
    encoder_v2_kernel_size: int = 5
    encoder_v2_out_units: int = 512
    encoder_v2_drop_rate: float = 0.5

    # Self attention (encoder side)
    self_attention_out_units: int = 32
    self_attention_num_heads: int = 2
    self_attention_num_hop: int = 1
    self_attention_encoder_out_units: int = 32
    self_attention_drop_rate: float = 0.05
    self_attention_transformer_num_conv_layers: int = 1
    self_attention_transformer_kernel_size: int = 5

    # Decoder
    decoder: str = "DualSourceTransformerDecoder"
    attention: str = "additive"  # additive | location_sensitive | forward
    forced_alignment_attention: str = "teacher_forcing_additive"

    # Dual source decoder
    attention2: str = "additive"
    forced_alignment_attention2: str = "teacher_forcing_additive"
    attention1_out_units: int = 224
    attention2_out_units: int = 32

    # Decoder V1
    decoder_prenet_drop_rate: float = 0.5
    apply_dropout_on_inference: bool = False
    decoder_prenet_out_units: Tuple[int, ...] = (256, 128)
    attention_out_units: int = 256
    decoder_out_units: int = 256

    # Decoder V2 attention
    attention_kernel: int = 31
    attention_filters: int = 32
    cumulative_weights: bool = False

    # Forward attention
    use_forward_attention_transition_agent: bool = False

    # Decoder self attention
    decoder_self_attention_out_units: int = 256
    decoder_self_attention_num_heads: int = 2
    decoder_self_attention_num_hop: int = 1
    decoder_self_attention_drop_rate: float = 0.05

    # Speaker embedding
    use_speaker_embedding: bool = False
    use_external_speaker_embedding: bool = False
    speaker_embedding_projection_out_dim: int = -1
    embedding_file: str = ""
    num_speakers: int = 1
    speaker_embedding_dim: int = 16
    speaker_embedding_offset: int = 0
    speaker_for_synthesis: int = -1
    speaker_embedd_to_prenet: bool = True
    speaker_embedd_to_decoder: bool = False
    speaker_embedd_to_postnet: bool = False

    # Post net
    post_net_cbhg_out_units: int = 256
    post_net_conv_channels: int = 128
    post_net_max_filter_width: int = 8
    post_net_projection1_out_channels: int = 256
    post_net_projection2_out_channels: int = 80
    post_net_num_highway: int = 4

    # Post net V2
    use_postnet_v2: bool = False
    num_postnet_v2_layers: int = 5
    postnet_v2_kernel_size: int = 5
    postnet_v2_out_channels: int = 512
    postnet_v2_drop_rate: float = 0.5

    # loss
    code_loss_type: str = "l1"  # l1 | mse
    spec_loss_type: str = "l1"  # l1 | mse (mel-spectrogram models)

    # --------------------------------------------------------------- Training
    batch_size: int = 32
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    initial_learning_rate: float = 0.002
    decay_learning_rate: bool = True
    learning_rate_step_factor: int = 1
    use_l2_regularization: bool = False
    l2_regularization_weight: float = 1e-7
    save_summary_steps: int = 50
    save_checkpoints_steps: int = 50
    keep_checkpoint_max: int = 20000
    keep_checkpoint_every_n_hours: int = 1
    log_step_count_steps: int = 1
    alignment_save_steps: int = 50
    save_training_time_metrics: bool = False
    approx_min_target_length: int = 100
    suffle_buffer_size: int = 64  # [sic] reference key name
    batch_bucket_width: int = 50
    batch_num_buckets: int = 50
    interleave_cycle_length_cpu_factor: float = 1.0
    interleave_cycle_length_min: int = 4
    interleave_cycle_length_max: int = 16
    interleave_buffer_output_elements: int = 200
    interleave_prefetch_input_elements: int = 200
    prefetch_buffer_size: int = 4
    use_cache: bool = False
    cache_file_name: str = ""
    logfile: str = "log.txt"
    record_profile: bool = False
    profile_steps: int = 50

    # Warm starting
    warm_start: bool = False
    ckpt_to_initialize_from: str = ""
    vars_to_warm_start: List[str] = _list_f()  # default [".*"] applied in __post_init__

    # ------------------------------------------------------------------- Eval
    max_iters: int = 450
    num_evaluation_steps: int = 5
    keep_eval_results_max_epoch: int = 10
    eval_start_delay_secs: int = 120
    eval_throttle_secs: int = 600

    # ---------------------------------------------------------------- Predict
    use_forced_alignment_mode: bool = False
    predicted_mel_extension: str = "mfbsp"

    # -------------------------------------------------------------- Extension
    use_zoneout_at_encoder: bool = False
    decoder_version: str = "v1"
    zoneout_factor_cell: float = 0.1
    zoneout_factor_output: float = 0.1

    # ----------------------------------------------------------------- Source
    phoneme: str = "flite"  # none | flite
    flite_binary_path: str = "flite"
    phoneset_path: str = ""

    # ------------------------------------------------------------- Preprocess
    trim_top_db: float = 30
    trim_frame_length: int = 1024
    trim_hop_length: int = 256
    num_silent_frames: int = 0
    preprocess_on_device: bool = False  # STFT/mel via the fused Pallas
    #   matmul-DFT kernel (ops/stft.py) instead of the NumPy path
    #   (cli/preprocess.py --on-device)

    # ======================================================= TPU-native extras
    # (not in the reference; defaults preserve reference behavior)
    compute_dtype: str = "float32"  # float32 | bfloat16 (params stay float32)
    mesh_shape: Tuple[int, ...] = ()  # () -> 1D data mesh over all devices
    mesh_axis_names: Tuple[str, ...] = ("data",)
    use_pallas_attention: bool = False
    decoder_min_iters: int = 10  # min decode steps before stop-token can fire
    decoder_early_stop: bool = True  # while_loop early exit at inference
    decoder_fused_inference: bool = False  # whole-loop Pallas decode kernel
    #                            (ops/fused_decode.py; batch-1 serving path)
    decoder_fused_dtype: str = "float32"  # float32 | bfloat16 in-kernel storage
    encoder_fused_inference: bool = False  # whole-encoder Pallas kernel at
    #                                  serving batch 1 (ops/fused_encoder.py)
    decoder_fused_train: bool = False  # fused Pallas teacher-forced training
    #                            scan (ops/fused_train.py): trunk weights
    #                            VMEM-resident across all steps, fwd + bwd
    decoder_fused_train_dtype: str = "float32"  # float32 | bfloat16 storage
    #                            inside the fused training scan
    decoder_scan_unroll: int = 4  # lax.scan unroll of the decode loops
    seed: int = 12345
    # multi-host mode glues per-host batch shards into one global array, so
    # every host must emit identical static shapes each step: fixed pad
    # lengths replace length-bucketed pads (parallel/multihost.py docstring)
    multihost_target_pad_length: int = 0  # 0 -> max_iters * outputs_per_step
    multihost_source_pad_length: int = 256
    # deterministic shared bucket schedule for multi-host lockstep shapes
    # (data/dataset.py:_iter_scheduled); falls back to the single fixed pad
    # when disabled or when multihost_target_pad_length is set explicitly
    multihost_bucket_schedule: bool = True
    multihost_bucket_weights: List[float] = _list_f()
    multihost_bucket_buffer_cap: int = 4096
    checkpoint_async: bool = True
    num_parallel_reads: int = 0  # 0 -> cpu_count based (reference train.py:33-37)
    native_reader: bool = True  # use the C++ TFRecord reader when built

    def __post_init__(self) -> None:
        if not self.vars_to_warm_start:
            self.vars_to_warm_start = [".*"]

    # ------------------------------------------------------------------- API
    def values(self) -> dict:
        return dataclasses.asdict(self)

    def set_hparam(self, name: str, value: Any) -> None:
        if not hasattr(self, name):
            raise ValueError(f"Unknown hparam: {name}")
        setattr(self, name, _coerce(value, getattr(self, name)))

    def parse_json(self, json_text: str) -> "HParams":
        """Layer a JSON object of overrides on top of the current values."""
        for name, value in json.loads(json_text).items():
            self.set_hparam(name, value)
        return self

    def parse_json_file(self, path: str) -> "HParams":
        with open(path) as f:
            return self.parse_json(f.read())

    def parse(self, spec: Optional[str]) -> "HParams":
        """Parse a ``name=value,name=value`` override string.

        Mirrors ``tf.contrib.training.HParams.parse`` for the subset of syntax
        the reference uses (scalars, booleans, strings; list values as
        ``name=[1,2]``).
        """
        if not spec:
            return self
        for name, raw in _split_assignments(spec):
            self.set_hparam(name, _parse_literal(raw))
        return self

    def replace(self, **kwargs: Any) -> "HParams":
        new = dataclasses.replace(self)
        for k, v in kwargs.items():
            new.set_hparam(k, v)
        return new

    def debug_string(self) -> str:
        values = self.values()
        lines = [f"  {name}: {values[name]}" for name in sorted(values)]
        return "Hyperparameters:\n" + "\n".join(lines)


def _split_assignments(spec: str):
    """Split 'a=1,b=[2,3],c=x' into (name, raw_value) pairs, bracket-aware."""
    items = []
    depth = 0
    token = []
    for ch in spec:
        if ch == "," and depth == 0:
            items.append("".join(token))
            token = []
            continue
        if ch in "[(":
            depth += 1
        elif ch in "])":
            depth -= 1
        token.append(ch)
    if token:
        items.append("".join(token))
    for item in items:
        if not item.strip():
            continue
        name, _, raw = item.partition("=")
        yield name.strip(), raw.strip()


def _parse_literal(raw: str) -> Any:
    if raw.lower() in ("true", "false"):
        return raw.lower() == "true"
    try:
        return json.loads(raw)
    except (json.JSONDecodeError, ValueError):
        return raw


def _coerce(value: Any, current: Any) -> Any:
    """Coerce an override to the field's existing type (bool/int/float/tuple)."""
    if isinstance(current, bool):
        if isinstance(value, str):
            return value.lower() == "true"
        return bool(value)
    if isinstance(current, int) and not isinstance(value, bool):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        return tuple(value) if isinstance(value, (list, tuple)) else (value,)
    if isinstance(current, list) and not isinstance(value, list):
        return [value]
    return value


def default_hparams() -> HParams:
    return HParams()


def hparams_debug_string(hp: HParams) -> str:
    return hp.debug_string()


def load_hparams(args) -> HParams:
    """Defaults -> ``args.hparam_json_file`` -> ``args.hparams`` (the
    layering of the JAX package's ``cli/train.py``)."""
    hp = default_hparams()
    if getattr(args, "hparam_json_file", None):
        hp.parse_json_file(args.hparam_json_file)
    hp.parse(getattr(args, "hparams", ""))
    return hp
