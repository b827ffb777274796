"""Host-side data of the port: OBJ meshes, image files, the view and
light-probe datasets and batch prefetching."""

from rnr_tpu_torch.data.dataset import (BatchLoader, LightProbeDataset,
                                        ViewDataset, apply_sampling_pattern,
                                        collate_views, glob_imgs, load_img)
from rnr_tpu_torch.data.obj import (Mesh, MeshData, load_mtl, load_obj,
                                    save_obj)

__all__ = ["BatchLoader", "LightProbeDataset", "Mesh", "MeshData",
           "ViewDataset", "apply_sampling_pattern", "collate_views",
           "glob_imgs", "load_img", "load_mtl", "load_obj", "save_obj"]
