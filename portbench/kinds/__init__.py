"""One module a configuration kind (the configuration file's ``kind``):
how the benchmark makes the kind's inputs on the device from the seed,
builds the program's ``Problem`` and reads its answers, and how the plain
reference judges them.  The harness finds a module by that name.

A kind module defines:

* ``make_inputs(cfg, traffic, gen, device)``: the shared inputs and the
  pool of ``traffic["pool"]`` batches of ``traffic["batch"]`` instances,
  made with the ``torch.Generator`` ``gen`` in a few large calls;
* ``problem(cfg, inputs, ftt)``: the program's ``Problem`` (``ftt`` is
  the imported ``fasta_tpu_torch``);
* ``reference_inputs(inputs, slots)``: the data of the kept instances,
  each slot a (batch, instance) pair;
* ``reference_solve(cfg, data, dtype)``: the plain reference's solve of
  those instances in ``dtype`` (float64; a lower one for a control);
* ``judge(cfg, data, kept)``: numbers from the kept answers and the plain
  reference's float64 solve of the same instances; those the
  configuration's ``limits`` name are compared, the rest printed.

The configuration's ``options`` (τ₀, tolerance, iteration limit, stopping
rule, mode, float64 decision scalars) are given to the route the serving
path chooses by ``harness.serving_kwargs``.
"""
