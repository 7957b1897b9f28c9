"""Preprocessing CLIs.

Counterpart of the JAX package's ``cli/preprocess.py``, with the same five
mains.  Parity targets: preprocess_ljspeech.py, preprocess_vctk.py,
preprocess_vqcodes.py, preprocess_vctk_e2e.py, preprocess_ljspeech_wavenet.py
(reference repo root) — corpus walk, parallel source/target extraction,
corpus mel statistics -> hparams.json, key list.csv.

Without ``--on-device`` the numpy STFT runs in a process pool, as in the
JAX package.  With it (or with ``preprocess_on_device`` set in the hparams)
the STFT runs through ``ops/stft.MelExtractor`` on ``--device`` (``cuda``
by default: the hand-written spectrogram kernel; ``cpu``: its plain
version), and one worker process is forced: a CUDA context must not be
forked into a pool.

    python -m self_attention_tacotron_torch.cli.preprocess ljspeech \
        IN_DIR OUT_DIR --hparam-json-file examples/ljspeech/tacotron.json \
        --on-device

The first argument names the main (ljspeech, ljspeech_wavenet, vctk,
vqcodes or vctk_e2e); without one the script's name selects it, as in the
JAX package.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def _common_args(p: argparse.ArgumentParser):
    p.add_argument("in_dir")
    p.add_argument("out_dir")
    p.add_argument("--hparams", default="")
    p.add_argument("--hparam-json-file", default=None)
    p.add_argument("--source-only", action="store_true")
    p.add_argument("--target-only", action="store_true")
    p.add_argument("--num-workers", type=int, default=0)
    _device_args(p)
    p.add_argument("--split", default=None, metavar="TRAIN:VAL:TEST",
                   help="also write train/validation/test.csv key lists with "
                        "these fractions (e.g. 0.9:0.05:0.05), seeded shuffle")
    p.add_argument("--split-seed", type=int, default=0)
    return p


def _device_args(p: argparse.ArgumentParser):
    p.add_argument("--on-device", action="store_true",
                   help="compute STFT/mel with the spectrogram kernel "
                        "(ops/stft.py) on --device instead of the NumPy "
                        "path; forces a single worker process (one CUDA "
                        "context)")
    p.add_argument("--device", default="cuda",
                   help="where --on-device runs the STFT (cuda, or cpu for "
                        "the kernel's plain version)")


def _load_hp(args):
    from ..config import default_hparams
    hp = default_hparams()
    if args.hparam_json_file:
        hp.parse_json_file(args.hparam_json_file)
    hp.parse(args.hparams)
    if getattr(args, "on_device", False):
        hp = hp.replace(preprocess_on_device=True)
    if hp.preprocess_on_device:
        args.num_workers = 1  # one CUDA context, never forked into a pool
    return hp


def _run(proc, args, with_stats=True):
    from ..data.preprocess.common import write_hparams_json, write_key_list
    log = logging.getLogger("preprocess")
    os.makedirs(args.out_dir, exist_ok=True)
    records = proc.list_files()
    log.info("%d utterances", len(records))
    keys = None
    if not args.target_only:
        keys = [k for k in proc.process_sources(records, args.num_workers)
                if k is not None]
        log.info("wrote %d source records", len(keys))
    if not args.source_only:
        results = [s for s in proc.process_targets(records, args.num_workers)
                   if s is not None]
        if with_stats and results and hasattr(proc, "corpus_statistics"):
            stats = proc.corpus_statistics(results)
            path = write_hparams_json(stats, args.out_dir)
            log.info("corpus statistics -> %s", path)
            keys = keys or [r.key for r in results]
        elif keys is None:
            keys = [r if isinstance(r, str) else r.key for r in results]
    if keys:
        write_key_list(keys, args.out_dir)
        if getattr(args, "split", None):
            paths = write_split_key_lists(keys, args.out_dir, args.split,
                                          args.split_seed)
            log.info("split key lists -> %s", ", ".join(paths))
    return 0


def write_split_key_lists(keys, out_dir: str, spec: str, seed: int = 0):
    """Split a corpus key list into train/validation/test.csv.

    The reference SHIPS its split lists (reference:
    examples/ljspeech/{train,validation,test}.csv) but has no in-repo tool
    that produces them; this closes that gap for new corpora with a seeded
    deterministic shuffle.
    """
    import random

    fracs = [float(x) for x in spec.split(":")]
    if len(fracs) != 3 or abs(sum(fracs) - 1.0) > 1e-6:
        raise ValueError(f"--split must be three fractions summing to 1, "
                         f"got {spec!r}")
    keys = list(keys)
    random.Random(seed).shuffle(keys)
    n = len(keys)
    n_train = int(round(fracs[0] * n))
    n_val = int(round(fracs[1] * n))
    splits = {"train.csv": keys[:n_train],
              "validation.csv": keys[n_train:n_train + n_val],
              "test.csv": keys[n_train + n_val:]}
    paths = []
    for name, part in splits.items():
        path = os.path.join(out_dir, name)
        with open(path, "w") as f:
            f.write("\n".join(part) + ("\n" if part else ""))
        paths.append(path)
    return paths


def main_ljspeech(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = _common_args(argparse.ArgumentParser()).parse_args(argv)
    from ..data.preprocess.ljspeech import LJSpeech
    hp = _load_hp(args)
    return _run(LJSpeech(args.in_dir, args.out_dir, hp, args.device), args)


def main_ljspeech_wavenet(argv=None) -> int:
    """Normalized-mel .mfbsp + wav export (reference:
    preprocess_ljspeech_wavenet.py)."""
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("in_dir")
    p.add_argument("mel_out_dir")
    p.add_argument("wav_out_dir")
    p.add_argument("--hparams", default="")
    p.add_argument("--hparam-json-file", default=None)
    p.add_argument("--num-workers", type=int, default=0)
    _device_args(p)
    args = p.parse_args(argv)
    from ..data.preprocess.ljspeech import LJSpeechWaveNet
    hp = _load_hp(args)
    os.makedirs(args.mel_out_dir, exist_ok=True)
    os.makedirs(args.wav_out_dir, exist_ok=True)
    proc = LJSpeechWaveNet(args.in_dir, args.mel_out_dir, args.wav_out_dir, hp,
                           args.device)
    keys = proc.process_wavs(proc.list_files(), args.num_workers)
    logging.getLogger("preprocess").info("wrote %d mel/wav pairs", len(keys))
    return 0


def main_vctk(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = _common_args(argparse.ArgumentParser())
    p.add_argument("--version", default="0.8", choices=["0.8", "0.9", "0.91"])
    args = p.parse_args(argv)
    from ..data.preprocess.vctk import VCTK, VCTK_v091
    hp = _load_hp(args)
    cls = VCTK_v091 if args.version == "0.91" else VCTK
    return _run(cls(args.in_dir, args.out_dir, hp, device=args.device), args)


def main_vqcodes(argv=None) -> int:
    """reference: preprocess_vqcodes.py:57-78."""
    logging.basicConfig(level=logging.INFO)
    p = _common_args(argparse.ArgumentParser())
    p.add_argument("--version", type=int, default=0,
                   help="0: keep all codes; 1/2: stride-2 downsample "
                        "starting at version-1")
    p.add_argument("--num-codes", type=int, default=1025)
    p.add_argument("--speaker-info", default="speaker-info.txt")
    p.add_argument("--siwis", action="store_true")
    p.add_argument("--accent-file", default=None,
                   help="'ID ACCENTS' table (speaker_selection/accents.txt "
                        "format); emits per-token accent ids into the source "
                        "records for the *WithAccentType encoders")
    args = p.parse_args(argv)
    from ..data.preprocess.codes import CODES, SiwisCodes
    hp = _load_hp(args)
    cls = SiwisCodes if args.siwis else CODES
    proc = cls(args.in_dir, args.out_dir, args.version, args.num_codes, hp,
               speaker_info_filename=args.speaker_info,
               accent_file=args.accent_file)
    return _run(proc, args, with_stats=False)


def main_vctk_e2e(argv=None) -> int:
    """Dispatch {vctk0.8, vctk0.9, vctk0.91, siwis} -> preprocessor
    (reference: preprocess_vctk_e2e.py:52-68)."""
    logging.basicConfig(level=logging.INFO)
    p = _common_args(argparse.ArgumentParser())
    p.add_argument("--corpus", required=True,
                   choices=["vctk0.8", "vctk0.9", "vctk0.91", "siwis"])
    args = p.parse_args(argv)
    from ..data.preprocess.codes import SiwisCodes
    from ..data.preprocess.vctk import VCTK, VCTK_v091
    hp = _load_hp(args)
    if args.corpus == "siwis":
        proc = SiwisCodes(args.in_dir, args.out_dir, 0, hp.num_mels, hp)
        return _run(proc, args, with_stats=False)
    cls = VCTK_v091 if args.corpus == "vctk0.91" else VCTK
    return _run(cls(args.in_dir, args.out_dir, hp, device=args.device), args)


MAINS = {"ljspeech": main_ljspeech,
         "ljspeech_wavenet": main_ljspeech_wavenet, "vctk": main_vctk,
         "vqcodes": main_vqcodes, "vctk_e2e": main_vctk_e2e}


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] in MAINS:
        sys.exit(MAINS[sys.argv[1]](sys.argv[2:]))
    name = os.path.basename(sys.argv[0])
    if "ljspeech_wavenet" in name:
        sys.exit(main_ljspeech_wavenet())
    if "ljspeech" in name:
        sys.exit(main_ljspeech())
    if "vqcodes" in name:
        sys.exit(main_vqcodes())
    if "e2e" in name:
        sys.exit(main_vctk_e2e())
    sys.exit(main_vctk())
