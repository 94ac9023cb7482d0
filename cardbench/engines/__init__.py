"""Engine adapters, one module each, named by a configuration's
``engine`` key: the only place the harness touches the program.

An adapter's ``Engine(cfg, filters, device)`` takes the first filter set
of the reference module's ``filters``.  For the ``render`` entry it gives
``group_samples`` and ``render(x)``; for ``live``, ``block``,
``cycle_blocks`` (how many blocks make one period of its schedule) and
``live(x)``; for both ``shapes(entry)`` and ``counts()``.

Where the traffic exchanges filters, the adapter also gives
``prepare(filters)`` and ``exchange(prepared)``.  Set-up hands each set
of the pool to ``prepare`` once, outside the window, and keeps what it
returns: the set as the deployment holds it between exchanges (a
head-tracked renderer keeps its HRTF sets in host memory), so any copy or
conversion between the harness's sets and the program's input is the
adapter's, and is paid there.  ``exchange`` is given one of those, inside
the timed block, and does only the program's own exchange work (the next
block fades to it)."""
