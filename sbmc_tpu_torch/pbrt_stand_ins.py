"""Test doubles for the two external binaries of the PBRT data path, which
the repo does not hold, and the helpers that compare scene files.

    from sbmc_tpu_torch import pbrt_stand_ins
    pbrt, obj2pbrt = pbrt_stand_ins.install(DIR)  # two executables in DIR

- ``obj2pbrt`` stands for PBRT's ``.obj`` converter. It reads the ``g
  <geom>@<mat>`` groups that ``ObjConverter`` tags a copy of the ``.obj``
  with and writes, for each group with faces, ``# Name "<geom>@<mat>"``, an
  ``AttributeBegin``, a ``Material`` line with roughness 0.5, index 1.5
  and opacity 1 (the ``.mtl`` is not read), a ``Shape "trianglemesh"`` with
  the group's vertices and fan-triangulated faces, and ``AttributeEnd``. An
  ``.obj`` without groups is one object named after its file.
- ``pbrt`` stands for the patched PBRTv2 renderer. It reads the scene's
  render block as PBRT does (the last ``Film``, ``Sampler``, ``Renderer``
  and ``Camera`` statements win), fails as PBRT would when a file the scene
  names (``Include``, image textures, environment maps) does not resolve,
  and writes into its working directory either the sample-recording
  renderer's ``.bin`` tiles (``Renderer "rendernet"``: one tile of
  ``tilesize`` pixels per block of the film's crop window, named
  ``%04d_%04d.bin`` by tile row and column, ``recordedsamples`` samples,
  ``pixelsamples`` as the ground-truth count) in the format of
  :mod:`sbmc_tpu_torch.data.bin_format`, or the film's EXR (default
  ``pbrt.exr``) at the crop window's size. Its pixels are cheap, not light
  transport: :mod:`sbmc_tpu_torch.data.synthetic` renders a sphere scene
  seeded by the scene file (its ids normalised, see
  :func:`normalise_scene`) at 2 distinct samples, repeated up to
  ``recordedsamples``, and 1 ground-truth pass; the path probabilities and
  light directions are constants.

No CLI of the port runs them: the tests and ``chip_smoke.py`` do, through
:func:`install`, in place of the binaries that a real corpus needs.
"""

import hashlib
import os
import re
import stat
import sys
import zlib

__all__ = ["install", "obj2pbrt", "pbrt", "write_asset_lists",
           "normalise_scene", "scene_digest", "scene_body", "main"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Distinct samples and ground-truth passes the pbrt stand-in traces a tile.
SAMPLE_PASSES, GT_PASSES = 2, 1
#: The ids the scene generator draws from ``uuid.uuid4()``, in either of
#: the two spellings it writes (``-`` in texture and material ids, ``_`` in
#: converted geometry).
_UUID_RE = re.compile(r"[0-9a-f]{8}([-_])[0-9a-f]{4}\1[0-9a-f]{4}\1"
                      r"[0-9a-f]{4}\1[0-9a-f]{12}")
_TOKEN_RE = re.compile(r'"[^"]*"|\[|\]|[^\s"\[\]]+')


def install(dst):
    """Write the ``pbrt`` and ``obj2pbrt`` stand-ins into ``dst`` as
    executables that run this module with this interpreter; returns their
    paths."""
    os.makedirs(dst, exist_ok=True)
    paths = []
    # obj2pbrt runs once an object: -S skips site (it needs the standard
    # library only), which takes most of an interpreter's start.
    for name, flags in (("pbrt", ""), ("obj2pbrt", " -S")):
        path = os.path.join(dst, name)
        with open(path, "w") as f:
            f.write("#!%s%s\nimport sys\nsys.path.insert(0, %r)\n"
                    "from sbmc_tpu_torch.pbrt_stand_ins import main\n"
                    "sys.exit(main([%r] + sys.argv[1:]))\n"
                    % (sys.executable, flags, ROOT, name))
        os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR | stat.S_IXGRP
                 | stat.S_IXOTH)
        paths.append(path)
    return tuple(paths)


# -- obj2pbrt ---------------------------------------------------------------

def obj2pbrt(src, dst):
    """Convert the ``.obj`` ``src`` into the ``obj2pbrt``-shaped ``dst``."""
    stem = os.path.splitext(os.path.basename(src))[0]
    verts, groups = [], {}
    group = stem
    with open(src) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v":
                verts.append(tok[1:4])
            elif tok[0] == "g":
                group = " ".join(tok[1:])
            elif tok[0] == "f":
                idx = [int(t.split("/")[0]) for t in tok[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                groups.setdefault(group, []).extend(
                    (idx[0], idx[j], idx[j + 1])
                    for j in range(1, len(idx) - 1))
    with open(dst, "w") as out:
        out.write("# Converted from %s\n" % os.path.basename(src))
        for name, tris in groups.items():
            used = sorted({i for tri in tris for i in tri})
            local = {v: i for i, v in enumerate(used)}
            out.write('# Name "%s"\nAttributeBegin\n' % name)
            out.write('Material "uber" "float roughness" [0.5] "float index" '
                      '[1.5] "rgb opacity" [1 1 1] "rgb Kd" [0.5 0.5 0.5]\n')
            out.write('Shape "trianglemesh" "integer indices" [%s]\n'
                      % " ".join(str(local[i]) for tri in tris for i in tri))
            out.write('"point P" [%s]\n' % " ".join(
                c for v in used for c in verts[v]))
            out.write("AttributeEnd\n")


# -- pbrt -------------------------------------------------------------------

def _statements(text):
    """``[(directive, [args])]`` of a PBRT scene up to ``WorldBegin``; an
    argument is a quoted string, a list of tokens or a bare token."""
    out = []
    head = re.sub(r"^\s*#.*$", "", text.split("WorldBegin")[0], flags=re.M)
    tokens = _TOKEN_RE.findall(head)
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        i += 1
        if tok == "[":
            j = tokens.index("]", i)
            out[-1][1].append(tokens[i:j])
            i = j + 1
        elif tok.startswith('"') or not tok[0].isupper():
            out[-1][1].append(tok)
        else:
            out.append((tok, []))
    return out


def _params(args):
    """``{name: values}`` of a statement's ``"type name" [values]`` pairs."""
    out = {}
    for key, val in zip(args, args[1:]):
        if isinstance(key, str) and key.startswith('"') and " " in key:
            vals = val if isinstance(val, list) else [val]
            out[key.strip('"').split()[1]] = [v.strip('"') for v in vals]
    return out


def _render_options(text):
    """The last statement of each render directive, as PBRT keeps it."""
    opts = {}
    for name, args in _statements(text):
        if name in ("Film", "Sampler", "Renderer", "Camera",
                    "SurfaceIntegrator"):
            kind = args[0].strip('"') if args and isinstance(
                args[0], str) else ""
            opts[name] = (kind, _params(args))
    return opts


def _referenced_files(text):
    """The files a scene names: ``Include`` paths, image filenames and
    environment maps."""
    return (re.findall(r'^Include\s+"([^"]+)"', text, re.M)
            + re.findall(r'"string (?:mapname|filename)" \["([^"]+)"\]',
                         text))


def _crop(film):
    """Pixel origin and size of the film's crop window."""
    xres = int(film["xresolution"][0])
    yres = int(film["yresolution"][0])
    c = [float(v) for v in film.get("cropwindow", [0, 1, 0, 1])]
    x0, x1 = round(xres * c[0]), round(xres * c[1])
    y0, y1 = round(yres * c[2]), round(yres * c[3])
    return x0, y0, x1 - x0, y1 - y0


def _tile(scene, rng, ts, spp, gt_spp, bx, by, width, height, camera):
    import numpy as np
    from sbmc_tpu_torch.data import bin_format, synthetic
    tile = synthetic.render_tile(scene, rng, ts=ts, spp=min(spp,
                                                            SAMPLE_PASSES),
                                 gt_spp=GT_PASSES, block_x=bx, block_y=by,
                                 image_width=width, image_height=height)
    reps = np.arange(spp) % tile.sample_count
    pd = bin_format.PATH_DEPTH
    tile.features = tile.features[reps]
    tile.p = np.full((spp, 4 * pd, ts, ts), np.log(0.5) / 30.0, np.float32)
    tile.ld = np.zeros((spp, 2 * pd, ts, ts), np.float32)
    tile.bt = tile.bt[reps]
    tile.sample_count, tile.gt_sample_count = spp, gt_spp
    lens = float(camera.get("lensradius", [0])[0])
    tile.aperture_radius = lens
    tile.focus_distance = (float(camera.get("focaldistance", [0])[0])
                           if lens > 0 else 0.0)
    tile.fov = float(camera.get("fov", [90])[0]) / 100.0
    return tile


def pbrt(scene_path, cwd="."):
    """Render ``scene_path`` as the stand-in does (module docstring) into
    ``cwd``; returns the files written."""
    import numpy as np
    from sbmc_tpu_torch.data import bin_format, synthetic
    with open(scene_path) as f:
        text = f.read()
    base = os.path.dirname(os.path.abspath(scene_path))
    for ref in _referenced_files(text):
        if not os.path.exists(os.path.join(base, ref)):
            raise FileNotFoundError("cannot open %s" % ref)
    opts = _render_options(text)
    film = opts["Film"][1]
    x0, y0, w, h = _crop(film)
    camera = opts.get("Camera", ("", {}))[1]
    seed = zlib.crc32(normalise_scene(text).encode())
    rng = np.random.RandomState(seed)
    scene = synthetic.random_scene(rng)
    written = []
    if opts.get("Renderer", ("", {}))[0] == "rendernet":
        r = opts["Renderer"][1]
        ts = int(r["tilesize"][0])
        spp = int(r["recordedsamples"][0])
        gt = int(opts["Sampler"][1]["pixelsamples"][0])
        if w % ts or h % ts:
            raise ValueError("tile size %d does not divide the %dx%d crop"
                             % (ts, w, h))
        for ty in range(h // ts):
            for tx in range(w // ts):
                tile = _tile(scene, rng, ts, spp, gt, tx * ts, ty * ts, w, h,
                             camera)
                path = os.path.join(cwd, "%04d_%04d.bin" % (ty, tx))
                bin_format.write_tile(path, tile)
                written.append(path)
        return written
    from sbmc_tpu_torch.utils import exr
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    img = np.stack([xx, yy, np.full_like(xx, rng.uniform())], -1)
    path = os.path.join(cwd, film.get("filename", ["pbrt.exr"])[0])
    exr.write(path, img.astype(np.float32))
    return [path]


# -- comparing scene files --------------------------------------------------

def write_asset_lists(dst, assets):
    """Write ``envmaps.txt``, ``textures.txt`` and ``models.txt`` into
    ``dst``, listing the sorted files of ``assets/envmaps``,
    ``assets/textures`` and the ``.obj`` files of ``assets/objs`` by
    absolute path; returns ``dst``."""
    os.makedirs(dst, exist_ok=True)
    for name, sub, ext in (("envmaps.txt", "envmaps", ""),
                           ("textures.txt", "textures", ""),
                           ("models.txt", "objs", ".obj")):
        folder = os.path.join(os.path.abspath(assets), sub)
        with open(os.path.join(dst, name), "w") as f:
            for fn in sorted(os.listdir(folder)):
                if fn.endswith(ext):
                    f.write(os.path.join(folder, fn) + "\n")
    return dst


def normalise_scene(text, roots=()):
    """``text`` with each ``uuid4`` id replaced by ``UUID<n>``, ``n`` its
    order of first appearance, and each of ``roots`` (a path, or ``(path,
    placeholder)``) by ``<ROOT0>``, ``<ROOT1>``... or its placeholder."""
    for i, root in enumerate(roots):
        path, mark = root if isinstance(root, tuple) else (root,
                                                           "<ROOT%d>" % i)
        text = text.replace(os.path.abspath(path), mark)
    seen = {}
    return _UUID_RE.sub(
        lambda m: seen.setdefault(m.group(0), "UUID%d" % len(seen)), text)


def scene_digest(texts):
    """sha256 of normalised scene files, independent of their order."""
    h = hashlib.sha256()
    for t in sorted(texts):
        h.update(t.encode())
        h.update(b"\0")
    return h.hexdigest()


def scene_body(text):
    """A generated scene without its render block: from its camera's
    ``LookAt`` on, which is what the rendering drivers take (they prepend a
    render block of their own)."""
    return text[re.search(r"^LookAt ", text, re.M).start():]


def main(argv):
    """``main(["pbrt", SCENE])`` or ``main(["obj2pbrt", IN.obj, OUT])``."""
    try:
        if argv[0] == "pbrt":
            pbrt(argv[1], os.getcwd())
        elif argv[0] == "obj2pbrt":
            obj2pbrt(argv[1], argv[2])
        else:
            raise ValueError("unknown stand-in %s" % argv[0])
    except (OSError, ValueError, KeyError) as e:
        print("%s: %s" % (argv[0], e), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
