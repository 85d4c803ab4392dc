"""Seconds from the process's start to the first timed step or request:
loading, building the inputs, warming up, and in a run that compiles,
compiling (host clock)."""


def read(view):
    return view.get("setup_s")
