"""Bytes that one iteration of the double-single dual-time iteration needs
at the least: it reads the Ht and Htau pairs and writes the Htau pair, two
float32 words a cell each (24 B a cell).  The ds tier tests after every
iteration, so every iteration is an interval.  The count does not depend on
which kernel does the work."""


def iteration_bytes(p: dict) -> float:
    return 24.0 * int(p["nx"]) * int(p["ny"]) * int(p["nz"])
