"""Device idle milliseconds a post-training step, a step running from the
start of one ``view.next`` to the next, each idle instant given to the
innermost program span the host was in then (``by_span``, which sums to
the value). ``outer_self_share`` is the part in the self time of
``post.step``; the program's device time inside ``post.step`` stands
beside the benchmark range's."""

from _program import idle_steps, window


def read(view):
    win = window(view)
    if win is None:
        return None
    return idle_steps(win, "view.next", ("post.step",))
