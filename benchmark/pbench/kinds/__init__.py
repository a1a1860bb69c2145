"""Traffic kinds: one module per `kind` of benchmark/traffic/*.json."""
