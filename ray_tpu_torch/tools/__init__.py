"""Developer tooling that ships with the repo (not part of the runtime
API surface). Currently: :mod:`ray_tpu_torch.tools.graftlint`."""
