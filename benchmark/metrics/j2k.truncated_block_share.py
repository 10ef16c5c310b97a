"""j2k.truncated_block_share: counter imgcodec.jpeg2k.codeblocks_truncated
(the part-1 code-blocks whose included coding passes end above bit-plane
0, codecs/jpeg2000/core.py) over counter imgcodec.jpeg2k.codeblocks
(every code-block Tier-1 decoded), in percent, over the traced window;
source: the program's counters. None where the program has no such
counter or decoded no code-block."""
UNIT = "%"
SOURCE = "program_counter"
TRUNCATED = "imgcodec.jpeg2k.codeblocks_truncated"
ALL = "imgcodec.jpeg2k.codeblocks"


def read(run):
    if TRUNCATED not in run.counters or not run.counters.get(ALL):
        return None
    return 100.0 * run.counters[TRUNCATED] / run.counters[ALL]
