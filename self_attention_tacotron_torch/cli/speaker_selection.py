"""Speaker/accent selection and key-list consistency tools.

A copy of the JAX package's ``cli/speaker_selection.py`` (it imports
nothing of JAX), kept so that the port depends on nothing of that package;
``scripts/run_vctk.sh`` runs it between preprocessing and training:

    python -m self_attention_tacotron_torch.cli.speaker_selection \
        crosscheck examples/vctk/train.csv DATA_DIR --out LISTS/train.csv

Parity targets:
* ``select_keys`` — filter an utterance key list to keys whose speaker
  appears in a speaker/accent list (reference:
  examples/codes/selected_speakers.py, speaker_selection/Am_Ca_Au_En.txt).
* ``filter_speakers_by_accent`` — build such a speaker list from an
  accents.txt table (reference: speaker_selection/accents.txt).
* ``cross_check`` — intersect a key list with the keys that actually exist
  on disk (reference: examples/codes/cross_check_file_exists.py,
  examples/codes_siwis/cross_check.py).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Sequence


def read_lines(path: str) -> List[str]:
    with open(path) as f:
        return [line.rstrip("\n") for line in f if line.strip()]


def filter_speakers_by_accent(accents_path: str,
                              accents: Sequence[str]) -> List[str]:
    """accents.txt ('ID ACCENTS' header) -> speaker ids with a kept accent."""
    keep = []
    for line in read_lines(accents_path)[1:]:
        parts = line.split()
        if len(parts) >= 2 and parts[1] in accents:
            keep.append(parts[0])
    return keep


def select_keys(keys: Sequence[str], speaker_ids: Sequence[str]) -> List[str]:
    """Keep utterance keys ('pNNN_XXX') whose speaker is in the list."""
    spk = {f"p{s}" if not s.startswith("p") else s for s in speaker_ids}
    return [k for k in keys if k.split("_")[0] in spk]


def cross_check(keys: Sequence[str], existing: Sequence[str]) -> List[str]:
    """Intersect keys with the stems of files that exist."""
    stems = {os.path.basename(e).split(".")[0] for e in existing}
    return [k for k in keys if k in stems]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("select", help="filter keys by speaker list")
    ps.add_argument("key_list")
    ps.add_argument("speaker_list",
                    help="file of 'ID ...' lines (speaker_selection format)")
    ps.add_argument("--out", default=None)

    pa = sub.add_parser("accents", help="speakers with given accents")
    pa.add_argument("accents_file")
    pa.add_argument("accent", nargs="+")
    pa.add_argument("--out", default=None)

    pc = sub.add_parser("crosscheck", help="drop keys missing on disk")
    pc.add_argument("key_list")
    pc.add_argument("data_dir")
    pc.add_argument("--extension", default="source.tfrecord")
    pc.add_argument("--out", default=None)

    args = p.parse_args(argv)
    if args.cmd == "select":
        speakers = [line.split()[0] for line in read_lines(args.speaker_list)]
        result = select_keys(read_lines(args.key_list), speakers)
        out = args.out or args.key_list + ".selected"
    elif args.cmd == "accents":
        result = filter_speakers_by_accent(args.accents_file, args.accent)
        out = args.out or args.accents_file + ".selected"
    else:
        existing = [f for f in os.listdir(args.data_dir)
                    if f.endswith(args.extension)]
        keys = read_lines(args.key_list)
        result = cross_check(keys, existing)
        removed = len(keys) - len(result)
        if removed:
            print(f"had to remove: {removed}")
        out = args.out or args.key_list + ".revised"
    with open(out, "w") as f:
        f.write("\n".join(result) + ("\n" if result else ""))
    print(f"wrote {len(result)} entries to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
