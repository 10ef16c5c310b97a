"""Write the streams of tests/torch_corpus: the progressive ones with the
test oracle (libjpeg's jpeg_simple_progression, restart interval 16) and
the restart-marker baseline ones with `torch_corpus.encode_dri`:

    python tests/torch_corpus/make_corpus.py
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(os.path.dirname(HERE)), os.path.dirname(HERE)]

import oracle  # noqa: E402
import torch_corpus as tc  # noqa: E402
from util import make_photo  # noqa: E402


def _write(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
    print(path, len(data))


def main() -> None:
    for s in tc.PROG_SEEDS:
        _write(tc.prog_path(s),
               oracle.jpeg_encode(make_photo(tc.PROG_H, tc.PROG_W, seed=s),
                                  tc.PROG_Q, "420", progressive=True,
                                  restart_interval=tc.PROG_RI))
    for s in tc.DRI_SEEDS:
        _write(tc.dri_path(s),
               tc.encode_dri(make_photo(tc.DRI_H, tc.DRI_W, seed=s),
                             tc.DRI_Q, tc.DRI_RI))


if __name__ == "__main__":
    main()
