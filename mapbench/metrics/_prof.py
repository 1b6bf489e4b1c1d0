"""Sums of the program's ``common/prof.py`` blocks over the window."""


def block_s(ctx, *names):
    """Seconds in the named blocks, or None where none of them ran."""
    found = [ctx.prof[n]["sum"] for n in names if n in ctx.prof]
    return sum(found) if found else None
