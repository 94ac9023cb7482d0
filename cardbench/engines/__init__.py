"""Engine adapters, one module each, named by a configuration's
``engine`` key: the only place the harness touches the program."""
