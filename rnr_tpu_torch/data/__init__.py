"""Host-side data of the port (OBJ meshes)."""

from rnr_tpu_torch.data.obj import Mesh, MeshData, load_obj

__all__ = ["Mesh", "MeshData", "load_obj"]
