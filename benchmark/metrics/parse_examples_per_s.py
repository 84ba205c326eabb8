"""The program's TSV source (``CriteoTSVSource``: line loop and native
parse) alone over the cell's file, for a fixed number of batches after the
window of a traced run, by the host clock."""


def read(ctx):
    if ctx.get("kind") != "fed":
        return None
    return ctx.get("parse_examples_per_s")
