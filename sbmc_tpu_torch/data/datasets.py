"""Datasets of ``.bin`` sample tiles (counterpart of
``sbmc_tpu/data/datasets.py``).

``TilesDataset`` reads per-sample ``.bin`` tiles (a ``.txt`` filelist or a
folder of scene folders), selects the feature subsets and preprocesses them
into what the models expect: "sbmc" (log-compressed radiance inputs),
"kpcn" (the pixel statistics of Bako et al. 2017) or "raw" (untouched).
``FullImagesDataset`` assembles all tiles of a scene into full-resolution
buffers, and ``MultiSampleCountDataset`` concatenates
datasets at spp 2..N for variable-sample-count training. Items are dicts of
numpy arrays; batching is :mod:`sbmc_tpu_torch.data.loader`'s and device
placement the caller's.
"""

import os

import numpy as np

from sbmc_tpu_torch.data import bin_format

__all__ = ["TilesDataset", "FullImagesDataset", "MultiSampleCountDataset"]

#: Records beyond this magnitude are treated as corrupt and zeroed on read
#: (no legitimate channel approaches it), as in the JAX package.
_SANE_MAX = 1e4


class TilesDataset:
    """Fetches preprocessed sample tiles stored in ``.bin`` files.

    Args:
      path: a ``.txt`` filelist or a root folder of scene folders.
      spp: number of samples per pixel to load (file may contain more).
      load_coords: include the subpixel/lens/time coordinate features.
      load_gbuffer: include depth/normals/albedo/visibility features.
      load_p: include the path-sampling probability features.
      load_ld: include the light-direction features.
      load_bt: include the decoded bounce-type features.
      mode: "sbmc" (log-compressed radiance inputs), "kpcn" (pixel
        statistics; 27 input channels per stream, no global features) or
        "raw" (no transformation). "kpcn" and "raw" load the g-buffer and
        none of the other optional features, whatever the flags say.
      cache_preprocessed: keep every preprocessed item in RAM, its features
        as float16, so that epochs after the first only stack cached
        arrays.
    """

    FILELIST_MODE = 0
    FOLDERS_MODE = 1

    PATH_DEPTH = bin_format.PATH_DEPTH
    SBMC_MODE = "sbmc"
    RAW_MODE = "raw"
    KPCN_MODE = "kpcn"

    def __init__(self, path, spp=None, load_coords=True, load_gbuffer=True,
                 load_p=True, load_ld=True, load_bt=True, mode="sbmc",
                 cache_preprocessed=False):
        if mode not in (self.SBMC_MODE, self.RAW_MODE, self.KPCN_MODE):
            raise RuntimeError("Unknown dataset loading mode %s" % mode)
        self.mode = mode
        self.cache_preprocessed = cache_preprocessed
        self._cache = {}
        self.load_coords = load_coords
        self.load_gbuffer = load_gbuffer
        self.load_p = load_p
        self.load_ld = load_ld
        self.load_bt = load_bt
        if self.mode != self.SBMC_MODE:
            self.load_coords = False
            self.load_gbuffer = True
            self.load_p = False
            self.load_ld = False
            self.load_bt = False

        self._init_filelist(path)
        self.image_channels = list(bin_format.PIXEL_CHANNEL_LABELS)
        self.glabels = ["aperture_radius", "focus_distance", "fov"]
        self._init_feature_labels()
        self._init_metadata(spp)

    def _init_filelist(self, path):
        if os.path.splitext(path)[-1] == ".txt":
            self.io_mode = self.FILELIST_MODE
            self.root = os.path.dirname(path)
            with open(path) as fid:
                self.files = [os.path.join(self.root, line.strip())
                              for line in fid if line.strip()]
            self.scenes = None
            self.indices = None
        elif os.path.isdir(path):
            self.io_mode = self.FOLDERS_MODE
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
        else:
            raise RuntimeError("Incorrect data path.")
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
        return 27 if self.mode == self.KPCN_MODE else len(self.labels)

    @property
    def num_global_features(self):
        return 0 if self.mode == self.KPCN_MODE else len(self.glabels)

    def __repr__(self):
        return ("TilesDataset(v%d, %dx%d image, tile %d, %d/%d spp, "
                "%d features + %d global)" %
                (self.version, self.image_width, self.image_height,
                 self.tile_size, self.spp, self.sample_count,
                 len(self.labels), len(self.glabels)))

    def __getitem__(self, idx):
        if self.cache_preprocessed and idx in self._cache:
            return self._cache[idx]
        sample = self._get_raw_data(idx)
        if self.mode == self.KPCN_MODE:
            sample = self._preprocess_kpcn(sample)
        elif self.mode == self.SBMC_MODE:
            sample = self._preprocess_standard(sample)
        if self.cache_preprocessed:
            if "features" in sample \
                    and sample["features"].dtype == np.float32:
                sample["features"] = sample["features"].astype(np.float16)
            self._cache[idx] = sample
        return sample

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

    def _preprocess_kpcn(self, sample):
        """Build the pixel-statistics inputs of Bako et al. 2017: per
        stream the colour, the gradients of normals, depth, albedo and
        colour, and the variances of all five (27 channels)."""
        src_f = sample["features"]
        spp = src_f.shape[0]

        idx = self.labels.index("depth")
        depth = src_f[:, idx:idx + 1].mean(0)
        depth_v = src_f[:, idx:idx + 1].var(0)
        max_depth = depth.max()
        if max_depth > 0:
            depth /= max_depth
            depth_v /= max_depth * max_depth * spp
        depth = np.clip(depth, 0, 1)

        idx = self.labels.index("albedo_r")
        albedo = src_f[:, idx:idx + 3].mean(0) + 0.00316
        albedo_v = src_f[:, idx:idx + 3].var(0).mean(0, keepdims=True) / spp
        albedo_sqr = (albedo * albedo).mean(0, keepdims=True)

        idx = self.labels.index("diffuse_r")
        diffuse = np.maximum(src_f[:, idx:idx + 3].mean(0), 0)
        diffuse_v = src_f[:, idx:idx + 3].var(0).mean(0, keepdims=True) / spp

        idx = self.labels.index("specular_r")
        specular = np.maximum(src_f[:, idx:idx + 3].mean(0), 0)
        specular_v = src_f[:, idx:idx + 3].var(0).mean(0, keepdims=True) / spp

        diffuse = diffuse / albedo
        diffuse_v = diffuse_v / albedo_sqr

        specular = np.log(1 + specular)
        specular_v = specular_v / (
            ((1 + specular) * (1 + specular)).mean(0, keepdims=True) + 1e-5)

        idx = self.labels.index("normal_x")
        normals = src_f[:, idx:idx + 3].mean(0)
        normals_v = src_f[:, idx:idx + 3].var(0).mean(0, keepdims=True) / spp

        normals_g = self._gradients(normals)
        depth_g = self._gradients(depth)
        albedo_g = self._gradients(albedo)
        specular_g = self._gradients(specular)
        diffuse_g = self._gradients(diffuse)

        out = {
            "kpcn_diffuse_in": np.concatenate(
                [diffuse, normals_g, normals_v, depth_g, depth_v, albedo_g,
                 albedo_v, diffuse_g, diffuse_v], 0),
            "kpcn_specular_in": np.concatenate(
                [specular, normals_g, normals_v, depth_g, depth_v, albedo_g,
                 albedo_v, specular_g, specular_v], 0),
            "kpcn_diffuse_buffer": diffuse,
            "kpcn_specular_buffer": specular,
            "kpcn_albedo": albedo,
        }
        for k in ["target_image", "low_spp", "spp", "block_x", "block_y"]:
            out[k] = sample[k]
        return out

    @staticmethod
    def _gradients(buf):
        """Horizontal and vertical forward differences, zero-padded at the
        leading edge."""
        dy = buf[:, 1:] - buf[:, :-1]
        dx = buf[:, :, 1:] - buf[:, :, :-1]
        dx = np.pad(dx, [[0, 0], [0, 0], [1, 0]], mode="constant")
        dy = np.pad(dy, [[0, 0], [1, 0], [0, 0]], mode="constant")
        return np.concatenate([dx, dy], 0)


class FullImagesDataset:
    """Assembles all tiles of each scene folder into full-res buffers."""

    def __init__(self, *args, **kwargs):
        self.tiles_dset = TilesDataset(*args, **kwargs)
        if self.tiles_dset.io_mode != TilesDataset.FOLDERS_MODE:
            raise RuntimeError("TilesDataset should be in folder mode.")
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

    @property
    def labels(self):
        return self.tiles_dset.labels

    @property
    def glabels(self):
        return self.tiles_dset.glabels


class MultiSampleCountDataset:
    """Concatenation of TilesDatasets at spp 2..N for variable-sample-count
    training. Use with the padded collation of
    :mod:`sbmc_tpu_torch.data.loader`, which masks the unused sample slots
    so that every batch has one shape."""

    def __init__(self, *args, **kwargs):
        spp = kwargs.get("spp", None)
        if spp is None:
            raise RuntimeError("spp not provided.")
        if spp < 2:
            raise RuntimeError("spp too low to randomize sample count, "
                               "should be at least 2.")
        self.datasets = []
        for _s in range(2, spp + 1):
            kwargs["spp"] = _s
            self.datasets.append(TilesDataset(*args, **kwargs))
        self._cum = np.cumsum([len(d) for d in self.datasets])
        self.max_spp = spp
        self.labels = self.datasets[0].labels
        self.glabels = self.datasets[0].glabels
        self.version = self.datasets[0].version
        self.num_features = self.datasets[0].num_features
        self.num_global_features = self.datasets[0].num_global_features

    def __len__(self):
        return int(self._cum[-1])

    def __getitem__(self, idx):
        d = int(np.searchsorted(self._cum, idx, side="right"))
        base = 0 if d == 0 else int(self._cum[d - 1])
        return self.datasets[d][idx - base]
