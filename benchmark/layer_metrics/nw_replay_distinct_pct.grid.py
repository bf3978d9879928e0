"""Share of the traced grids' rows whose op stream the host replayed: 100 x the program's ``ta.nw.replay_one`` spans (one a ``replay_ops`` call) over the rows of the traced grids (their records' ``units``)."""


def read(ctx):
    replays = sum(name == "ta.nw.replay_one" for name, _, _ in ctx.host)
    rows = sum(rec["units"] for rec in ctx.traced)
    if not replays or not rows:
        return None
    return 100.0 * replays / rows
