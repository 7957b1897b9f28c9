"""VQ-code postprocessing: prediction records -> code-id text files.

The port of the JAX package's ``cli/postprocess.py`` (the reference's
``postprocess_vqcodes.py``): for every code prediction record in
``prediction_dir`` (``cli.predict``'s ``<key>.tfrecord``) write
``<key>.txt`` (the text), ``<key>.preds.txt`` and ``<key>.truth.txt``
(the argmax code ids, space-joined), and the corpus lists
``tacotron_<exp>.txt``, ``tacotron_<exp>.hypothesis.txt`` and
``tacotron_<exp>.true.txt`` for the external synthesizer.  numpy and the
port's record readers only; no device.

    python -m self_attention_tacotron_torch.cli.postprocess PRED_DIR OUT_DIR \\
        [--experiment NAME] [--list-out-dir DIR]
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import sys

import numpy as np


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("prediction_dir")
    p.add_argument("out_dir")
    p.add_argument("--experiment", default="exp")
    p.add_argument("--list-out-dir", default=None)
    args = p.parse_args(argv)
    log = logging.getLogger("postprocess")

    from ..data.records import parse_prediction_record
    from ..data.tfrecord import read_examples

    os.makedirs(args.out_dir, exist_ok=True)
    list_dir = args.list_out_dir or args.out_dir
    os.makedirs(list_dir, exist_ok=True)

    txtlist, predlist, truthlist = [], [], []
    records = sorted(glob.glob(os.path.join(args.prediction_dir,
                                            "*.tfrecord")))
    for record_file in records:
        for example in read_examples(record_file):
            try:
                result = parse_prediction_record(example)
            except (KeyError, TypeError):
                continue  # not a code prediction record
            codes_pred = np.argmax(result.codes, axis=1)
            codes_truth = (np.argmax(result.ground_truth_codes, axis=1)
                           if result.ground_truth_codes.size else
                           np.zeros(0, np.int64))
            base = os.path.join(args.out_dir, result.key)
            with open(base + ".txt", "w") as f:
                f.write(result.text)
            pred_str = " ".join(str(c) for c in codes_pred)
            with open(base + ".preds.txt", "w") as f:
                f.write(pred_str + "\n")
            truth_str = " ".join(str(c) for c in codes_truth)
            with open(base + ".truth.txt", "w") as f:
                f.write(truth_str + "\n")
            txtlist.append(result.key + ".txt")
            predlist.append(pred_str)
            truthlist.append(truth_str)
            log.info("postprocessed %s (%d codes)", result.key,
                     len(codes_pred))

    exp = args.experiment
    with open(os.path.join(list_dir, f"tacotron_{exp}.txt"), "w") as f:
        f.write("\n".join(txtlist))
    with open(os.path.join(list_dir, f"tacotron_{exp}.hypothesis.txt"),
              "w") as f:
        f.write("\n".join(predlist))
    with open(os.path.join(list_dir, f"tacotron_{exp}.true.txt"), "w") as f:
        f.write("\n".join(truthlist))
    log.info("wrote %d utterances", len(txtlist))
    return 0


if __name__ == "__main__":
    sys.exit(main())
