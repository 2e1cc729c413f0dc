"""Seeded traffic: one general generator per kind of input, driven by the
parameters of a mix file `traffic/<mix>.json`. Every seed gets the same set
of sizes, counts and gaps, in another order, so the work of a run does not
move with the seed."""
