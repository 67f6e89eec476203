"""Bytes that one check interval of the dual-time iteration needs at the
least: K iterations between two convergence tests read Ht and Htau once and
write Htau once, 4 bytes a float32 cell each (12 B a cell), since the test
needs the field at the interval's end.  The count does not depend on which
kernel does the work."""


def interval_bytes(p: dict) -> float:
    return 12.0 * int(p["nx"]) * int(p["ny"]) * int(p["nz"])
