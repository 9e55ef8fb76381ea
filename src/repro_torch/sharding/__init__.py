from repro_torch.sharding.context import (  # noqa: F401
    batch_axes, get_mesh, mesh_context, model_axis_size, set_mesh,
)
