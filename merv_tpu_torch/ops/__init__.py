# Intentionally empty, as in merv_tpu.ops: import merv_tpu_torch.ops.attention
# directly. Re-exporting the `attention` FUNCTION here would shadow the
# same-named submodule on the package object.
