"""Device idle milliseconds a flat training step, a step running from the
start of one ``view.next`` (the loop asking for its view) to the next,
each idle instant given to the innermost program span the host was in
then (``by_span``, which sums to the value; the loop's own code between
spans is "outside any span"). ``outer_self_share`` is the part in the
self time of ``train.step``; the program's device time inside
``train.step`` stands beside the benchmark range's."""

from _program import idle_steps, window


def read(view):
    win = window(view)
    if win is None:
        return None
    return idle_steps(win, "view.next", ("train.step",))
