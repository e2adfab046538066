"""Circuit generators, one module a generator, named by a configuration's
"generator" key: `build(cfg) -> Circuit` and `witness(circuit, cfg, rng) ->
list of ints`, the witness of one request drawn from `rng` (a
random.Random)."""
