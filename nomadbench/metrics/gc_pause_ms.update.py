"""Interpreter runtime: the collection pauses inside the window, from the
program's own ring of them, in ms a roll round (the window's
``register`` and ``round`` records). None where the program keeps no
ring or the ring dropped pauses of the window."""

from nomadbench import program


def read(run):
    rounds = run.window_records("register") + run.window_records("round")
    got = program.window_pauses(run.t0, run.t_close)
    if not rounds or got is None or not got[1]:
        return None
    return 1000.0 * sum(e - s for s, e in got[0]) / len(rounds)
