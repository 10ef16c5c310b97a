"""j2k.t1_device_block_share: counter imgcodec.jpeg2k.codeblocks_device
(the code-blocks whose Tier-1 the program sends to its kernel on the card,
ops/j2k_t1.py) over counter imgcodec.jpeg2k.codeblocks (every code-block
Tier-1 decoded), in percent, over the traced window; source: the program's
counters. None where the program has no such counter (one that predates
Tier-1 on the card) or decoded no code-block."""
UNIT = "%"
SOURCE = "program_counter"
DEVICE = "imgcodec.jpeg2k.codeblocks_device"
ALL = "imgcodec.jpeg2k.codeblocks"


def read(run):
    if DEVICE not in run.counters or not run.counters.get(ALL):
        return None
    return 100.0 * run.counters[DEVICE] / run.counters[ALL]
