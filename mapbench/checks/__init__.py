"""A cell's own output checks, ``<name>.py`` each, found by the name a cell
file gives under ``checks`` (``manifest.checks``).

A check has ``collect(mb, period)``, ``numbers(data, run)`` and may have
``control(run)``; ``mapbench/check.py`` says what each gets and when it is
called.  A check imports nothing of the program: ``collect`` reads
attributes of the builder it is handed, and the reference comes from
``mapbench/reference/``."""
