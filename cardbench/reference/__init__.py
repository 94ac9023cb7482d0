"""Plain float64 references, one module each, named by a configuration's
``engine`` key.  Nothing here imports the program.

A reference module gives ``filters(cfg, gen, device)``, one filter set as
its engine adapter takes it, made from ``gen``; ``memory(cfg)``, how many
past input samples one output depends on; ``EXCHANGE_LAW``, whether the
deployment states a law for an exchange of filters (a cell whose mix
exchanges is refused at set-up where it does not); and
``outputs(history, filters, n_out, *, before=None, precision="float64")``,
the last ``n_out`` outputs ``[outputs, n_out]`` over ``history [inputs,
memory + n_out]`` with the set active after them, and, on an exchange
block, with ``before``, the set active before it, by that law."""
