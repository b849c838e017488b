"""Model families: what the harness needs to know of one architecture.

A configuration names its family under ``program.family``; the harness
loads ``families/<family>.py`` by that name (``registry.family``), so a new
architecture is added as files only. A family module gives:

- ``model_config(cfg) -> (program config, loss_fn)``: the program's model
  config for a configuration file and its loss, ``loss_fn(params, batch,
  config)`` (imports of the program stay inside the function);
- ``param_specs(program config)``: the program's partition spec of each
  leaf, for a cell laid over a mesh;
- ``leaves(cfg)``: the parameter tree's leaves (``weights.Leaf``), in the
  tree's order, with their shapes and fan-ins;
- ``Model(cfg, num)``: the plain float32 reference, which imports nothing
  of the program, with ``loss_and_grads(params, tokens, grads=None,
  scale=1.0, pins=None) -> (mean loss of the rows, gradient tree)``: the
  gradient of ``scale`` times that mean, added into ``grads`` when given,
  every product through ``num.mm`` / ``num.q`` (``reference.Numerics``);
- ``matmul_params_per_token(cfg)`` and ``attention_flops_per_token(cfg,
  seq_len)``: a training token's model FLOPs are 6 x the first plus the
  second (``flops.train_flops_per_token``);
- optionally ``pins(params, batch, config) -> list``, one entry a row of
  the batch: discrete decisions the program makes in a check step (such as
  the experts each token is routed to), read before the step on the
  program's state and handed, row by row, to the reference's
  ``loss_and_grads`` as ``pins``. This is the one place where the
  reference follows the program: everything else it works out itself.
"""
