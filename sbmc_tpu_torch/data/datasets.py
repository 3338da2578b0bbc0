"""Datasets of ``.bin`` sample tiles (counterpart of
``sbmc_tpu/data/datasets.py`` in "sbmc" mode).

``TilesDataset`` reads per-sample ``.bin`` tiles from a folder of scene
folders, selects the feature subsets and log-compresses the radiance
inputs. ``FullImagesDataset`` assembles all tiles of a scene into
full-resolution buffers. Items are dicts of numpy arrays; device placement
is the caller's.

The "kpcn" and "raw" modes, ``.txt`` filelists and the variable-spp
training datasets come with the slices that port KPCN and training.
"""

import os

import numpy as np

from sbmc_tpu_torch.data import bin_format

__all__ = ["TilesDataset", "FullImagesDataset"]

#: Records beyond this magnitude are treated as corrupt and zeroed on read
#: (no legitimate channel approaches it), as in the JAX package.
_SANE_MAX = 1e4


class TilesDataset:
    """Fetches preprocessed sample tiles stored in ``.bin`` files.

    Args:
      path: a root folder of scene folders.
      spp: number of samples per pixel to load (file may contain more).
      load_coords: include the subpixel/lens/time coordinate features.
      load_gbuffer: include depth/normals/albedo/visibility features.
      load_p: include the path-sampling probability features.
      load_ld: include the light-direction features.
      load_bt: include the decoded bounce-type features.
      mode: must be "sbmc" (log-compressed radiance inputs).
    """

    PATH_DEPTH = bin_format.PATH_DEPTH

    def __init__(self, path, spp=None, load_coords=True, load_gbuffer=True,
                 load_p=True, load_ld=True, load_bt=True, mode="sbmc"):
        if mode != "sbmc":
            raise NotImplementedError(
                f"dataset mode {mode!r} is not ported yet (slice 3: KPCN)")
        self.load_coords = load_coords
        self.load_gbuffer = load_gbuffer
        self.load_p = load_p
        self.load_ld = load_ld
        self.load_bt = load_bt

        self._init_filelist(path)
        self.image_channels = list(bin_format.PIXEL_CHANNEL_LABELS)
        self.glabels = ["aperture_radius", "focus_distance", "fov"]
        self._init_feature_labels()
        self._init_metadata(spp)

    def _init_filelist(self, path):
        if not os.path.isdir(path):
            raise RuntimeError("Incorrect data path.")
        self.root = path
        scenes = sorted(os.path.join(path, d) for d in os.listdir(path))
        self.scenes = [s for s in scenes if os.path.isdir(s)]
        self.files = []
        self.indices = {}
        for s in self.scenes:
            beg = len(self.files)
            for f in sorted(os.listdir(s)):
                if os.path.splitext(f)[-1] == ".bin":
                    self.files.append(os.path.join(s, f))
            self.indices[s] = (beg, len(self.files))
        if not self.files:
            raise RuntimeError("Empty dataset")

    def _init_feature_labels(self):
        labels = []
        if self.load_coords:
            labels += ["dx", "dy", "lens_u", "lens_v", "t"]
        labels += ["diffuse_r", "diffuse_g", "diffuse_b",
                   "specular_r", "specular_g", "specular_b"]
        if self.load_gbuffer:
            labels += [
                "normal_first_x", "normal_first_y", "normal_first_z",
                "normal_x", "normal_y", "normal_z",
                "depth_first", "depth", "visibility", "hasHit",
                "albedo_first_r", "albedo_first_g", "albedo_first_b",
                "albedo_r", "albedo_g", "albedo_b",
            ]
        if self.load_p:
            labels += ["p"] * (self.PATH_DEPTH * 4)
        if self.load_ld:
            for i in range(self.PATH_DEPTH):
                labels += ["ld_theta_%d" % i, "ld_phi_%d" % i]
        if self.load_bt:
            for txt in ["reflection", "transmisson", "diffuse", "glossy",
                        "specular"]:
                for i in range(self.PATH_DEPTH):
                    labels.append("bt_%s_%d" % (txt, i))
        self.labels = labels

    def _init_metadata(self, spp):
        with open(self.files[0], "rb") as fid:
            meta, _ = bin_format.read_header(fid)
        self.version = meta["version"]
        self.tile_size = meta["tile_size"]
        self.image_width = meta["image_width"]
        self.image_height = meta["image_height"]
        self.sample_count = meta["sample_count"]
        self.gt_sample_count = meta["gt_sample_count"]
        self.sample_features = meta["sample_features"]
        self.pixel_features = meta["pixel_features"]
        self.path_depth = meta["path_depth"]
        if self.path_depth != self.PATH_DEPTH:
            raise RuntimeError("Incorrect path depth in the data")
        if spp is None:
            self.spp = self.sample_count
        elif spp > self.sample_count:
            raise RuntimeError("Requested too many samples.")
        else:
            self.spp = spp

    def __len__(self):
        return len(self.files)

    @property
    def num_features(self):
        return len(self.labels)

    @property
    def num_global_features(self):
        return len(self.glabels)

    def __getitem__(self, idx):
        return self._preprocess_standard(self._get_raw_data(idx))

    def _get_raw_data(self, idx):
        fname = self.files[idx]
        tile = bin_format.read_tile(fname, spp=self.spp)
        if (tile.tile_size != self.tile_size
                or tile.sample_features != self.sample_features
                or tile.pixel_features != self.pixel_features
                or tile.path_depth != self.path_depth):
            raise ValueError("Metadata do not match for %s" % fname)
        # Zero non-finite or absurd records, as the JAX package does.
        for name in ("pixel_data", "features", "p", "ld"):
            arr = getattr(tile, name)
            bad = ~np.isfinite(arr) | (np.abs(arr) > _SANE_MAX)
            if bad.any():
                arr = arr.copy()
                arr[bad] = 0.0
                setattr(tile, name, arr)

        sample = {
            "block_x": tile.block_x,
            "block_y": tile.block_y,
            "path": fname,
            "scene_radius": tile.scene_radius,
        }
        gf = {"aperture_radius": tile.aperture_radius,
              "focus_distance": tile.focus_distance, "fov": tile.fov}
        sample["global_features"] = np.array(
            [gf[k] for k in self.glabels],
            np.float32).reshape(len(self.glabels), 1, 1)

        nchans = tile.pixel_data.shape[0] // 2
        sample["image_data"] = tile.pixel_data[:nchans]
        sample["image_data_var"] = tile.pixel_data[nchans:2 * nchans]
        sample["target_image"] = (sample["image_data"][:3]
                                  + sample["image_data"][3:6])
        sample["spp"] = self.spp * np.ones((1, 1, 1), np.int32)

        # Assemble the selected feature planes in label order.
        parts = []
        feats = tile.features
        if self.load_coords:
            parts.append(feats[:, 0:5])
        parts.append(feats[:, 5:11])  # radiance, always kept
        if self.load_gbuffer:
            parts.append(feats[:, 11:27])
        if self.load_p:
            parts.append(tile.p)
        if self.load_ld:
            parts.append(tile.ld)
        if self.load_bt:
            parts.append(bin_format.decode_bounce_types(tile.bt))
        samples = np.concatenate(parts, axis=1)
        sample["features"] = np.ascontiguousarray(samples, np.float32).copy()

        i_d = self.labels.index("diffuse_r")
        i_s = self.labels.index("specular_r")
        sample["radiance"] = (samples[:, i_d:i_d + 3]
                              + samples[:, i_s:i_s + 3])
        sample["low_spp"] = sample["radiance"].mean(0)
        return sample

    def _preprocess_standard(self, sample):
        """Log-compress the radiance inputs: the diffuse slot becomes
        log(1 + diffuse + specular) / 10 and the specular slot
        log(1 + specular) / 10."""
        feats = sample["features"]
        i_d = self.labels.index("diffuse_r")
        i_s = self.labels.index("specular_r")
        diffuse = np.maximum(feats[:, i_d:i_d + 3], 0)
        specular = np.maximum(feats[:, i_s:i_s + 3], 0)
        total = diffuse + specular
        feats[:, i_d:i_d + 3] = np.log(1 + total) / 10.0
        feats[:, i_s:i_s + 3] = np.log(1 + specular) / 10.0
        sample["features"] = feats
        return sample


class FullImagesDataset:
    """Assembles all tiles of each scene folder into full-res buffers."""

    def __init__(self, *args, **kwargs):
        self.tiles_dset = TilesDataset(*args, **kwargs)
        self.scenes = self.tiles_dset.scenes

    def __len__(self):
        return len(self.scenes)

    def get_scene_name(self, idx):
        return self.scenes[idx]

    def __getitem__(self, idx):
        scene = self.scenes[idx]
        start_idx, end_idx = self.tiles_dset.indices[scene]
        first = self.tiles_dset[start_idx]

        ts = self.tiles_dset.tile_size
        width = self.tiles_dset.image_width
        height = self.tiles_dset.image_height

        sample = {}
        tensor_keys = []
        for k, v in first.items():
            if k in ("global_features", "scene_radius"):
                sample[k] = v
            elif isinstance(v, np.ndarray):
                tensor_keys.append(k)
                shape = list(v.shape)
                shape[-2] = height
                shape[-1] = width
                sample[k] = np.zeros(shape, v.dtype)

        for tidx in range(start_idx, end_idx):
            tile = first if tidx == start_idx else self.tiles_dset[tidx]
            bx, by = tile["block_x"], tile["block_y"]
            for k in tensor_keys:
                sample[k][..., by:by + ts, bx:bx + ts] = tile[k]
        return sample

    @property
    def spp(self):
        return self.tiles_dset.spp

    @property
    def num_features(self):
        return self.tiles_dset.num_features

    @property
    def num_global_features(self):
        return self.tiles_dset.num_global_features
