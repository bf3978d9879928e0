"""Share of the traced folios whose raster and line finding ran on the card: 100 x the program's ``ta.raster.card`` spans (``pipeline.process`` opens one a folio that takes the card route) over the traced items."""


def read(ctx):
    spans = sum(name == "ta.raster.card" for name, _, _ in ctx.host)
    if not spans or not ctx.traced:
        return None
    return 100.0 * spans / len(ctx.traced)
