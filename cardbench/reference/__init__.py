"""Plain float64 references, one module each, named by a configuration's
``engine`` key.  Nothing here imports the program."""
