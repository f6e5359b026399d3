"""The bulb frame's colour (ops/bulb_shade.py) on the CPU: the plain
version, which the CPU frame runs, against the torch glue the bulb frame
ran before K4c (frozen below from models/mandelbulb.py), bit for bit; the
quantized store against ``quantize_image``; the dispatcher's choice; the
argument checks of K4c's wrapper; and the constants K4c folds from
Python's doubles.  K4c itself runs against the plain version in
test_torch_cuda.py on the card."""
import math
import os
import re
from dataclasses import replace

import numpy as np
import pytest
import torch

from fractalrenderer_tpu_torch import FractalType, Scene
from fractalrenderer_tpu_torch.models import mandelbulb
from fractalrenderer_tpu_torch.ops import _cuda
from fractalrenderer_tpu_torch.ops import bulb_math as bm
from fractalrenderer_tpu_torch.ops import bulb_shade as bs
from fractalrenderer_tpu_torch.ops import coloring, consts
from fractalrenderer_tpu_torch.ops.bulb_kernel import march_fields
from fractalrenderer_tpu_torch.ops.coloring import quantize_image

W, H = 24, 16


def _glue_band(scene, width, band_h, full_h, row0, device="cpu"):
    """The bulb band as the port rendered it before K4c: the frame's
    vector, then per sample the ray grid, K4a and K4b, ``shade_hit``,
    ``sky_color`` and the select, the AA sum, and the post chain
    (models/mandelbulb.py's ``band_render_fn`` and ``_render_sample``,
    copied with their spans left out)."""
    fields = ("camera_distance", "rotation_y", "power", "time", "fov",
              "rotation_speed", "color_offset", "color_scale", "brightness",
              "saturation", "contrast")
    keys = (*fields, "dyn_power", "ro_x", "ro_y", "ro_z")
    base = mandelbulb._bulb_params(scene)
    int_power = mandelbulb._static_int_power(base)
    dyn = mandelbulb.dyn_params(scene)
    p = replace(base, **{k: np.float32(dyn[k]) for k in fields})
    ro, dyn_power = bm.camera_setup(p)
    vals = torch.tensor([float(getattr(p, k)) for k in fields]
                        + [float(dyn_power)] + [float(v) for v in ro],
                        dtype=torch.float32, device=device)
    dyn_t = {k: vals[i] for i, k in enumerate(keys)}
    aa = p.aa_samples
    acc = torch.zeros((band_h, width, 3), dtype=torch.float32, device=device)
    for sy in range(aa):
        for sx in range(aa):
            off = (sx / aa, sy / aa)
            dev = dyn_t["fov"].device
            ro_t = tuple(dyn_t[k] for k in ("ro_x", "ro_y", "ro_z"))
            f32 = torch.float32
            pyg = torch.arange(band_h, dtype=f32, device=dev)[:, None] \
                .expand(band_h, width)
            pxg = torch.arange(width, dtype=f32, device=dev)[None, :] \
                .expand(band_h, width)
            pxg = pxg + float(np.float32(off[0]))
            pyg = pyg + float(np.float32(off[1]))
            if row0:
                pyg = pyg + float(row0)
            rd = bm.ray_dirs(pxg, pyg, width, full_h, ro_t, dyn_t["fov"])
            f = march_fields(width, band_h, ro=ro, fov=p.fov,
                             power=dyn_power, max_iter=p.max_iterations,
                             offset=off, row0=row0, map_height=full_h,
                             shade=True, int_power=int_power, device=device)
            hit = f["hit"] > 0.5
            t = f["t"]
            pos = tuple(o + r * t for o, r in zip(ro_t, rd))
            pt = replace(p, **{k: dyn_t[k] for k in ("color_offset",
                                                     "color_scale", "time")})
            hit_color = bm.shade_hit(pos, (f["nx"], f["ny"], f["nz"]), rd,
                                     f["d"], f["esc"], t, pt,
                                     dyn_t["dyn_power"], ao_sum=f["ao"])
            acc = acc + torch.where(hit[..., None], hit_color,
                                    bm.sky_color(rd))
    color = acc / consts.f32(aa * aa, acc.device)
    color = coloring.enhance_color(color, dyn_t["brightness"],
                                   dyn_t["saturation"], dyn_t["contrast"])
    return coloring.gamma_correct(coloring.aces_tonemap(color))


def _scene(**kw):
    return Scene(fractal_type=FractalType.MANDELBULB, max_iterations=16,
                 **kw)


_FRAMES = {
    "trig": dict(time=1.3),
    "int_power_time0": dict(),
    "aa2": dict(time=0.4, antialiasing_samples=2),
    "aa3": dict(time=0.7, antialiasing_samples=3),
    **{f"palette{m}": dict(time=2.0, palette_mode=m) for m in range(6)},
}


@pytest.mark.parametrize("name", list(_FRAMES))
def test_cpu_frame_equals_the_glue_it_replaced(name):
    scene = _scene(**_FRAMES[name])
    img = mandelbulb.render(scene, W, H, device="cpu")
    want = _glue_band(scene, W, H, H, 0)
    assert img.dtype == torch.float32 and img.shape == (H, W, 3)
    assert torch.equal(img, want)
    assert 0.02 < float(img.std())  # bulb and sky


@pytest.mark.parametrize("aa", [1, 3])
def test_cpu_ragged_band_equals_the_glue_it_replaced(aa):
    # rows [29, 38) of 64: the ray grid's (y + oy) + row0 with the offsets
    # of a 3x3 AA frame
    scene = _scene(time=1.1, antialiasing_samples=aa)
    fn = mandelbulb.band_render_fn(scene, 37, 9, 64, device="cpu")
    got = fn(mandelbulb.dyn_params(scene), 29)
    assert got.shape == (9, 37, 3)
    assert torch.equal(got, _glue_band(scene, 37, 9, 64, 29))


@pytest.mark.parametrize("bits", [8, 16])
def test_quantized_band_equals_quantize_image_of_the_f32_band(bits):
    scene = _scene(time=1.3, antialiasing_samples=2)
    dyn = mandelbulb.dyn_params(scene)
    f32 = mandelbulb.band_render_fn(scene, W, 9, H, device="cpu")(dyn, 5)
    q = mandelbulb.band_render_fn(scene, W, 9, H, device="cpu",
                                  quantize=bits)(dyn, 5)
    assert q.dtype == (torch.uint8 if bits == 8 else torch.uint16)
    assert torch.equal(q, quantize_image(f32, bit_depth=bits))
    frame = mandelbulb.render(scene, W, H, device="cpu", quantize=bits)
    assert torch.equal(frame[5:14], q)


def _sample(scene=None, rows=H, row0=0, map_height=H):
    """One sample's K4b planes (the plain versions) and its vector."""
    p = mandelbulb._bulb_params(scene or _scene(time=1.3))
    ro, dyn_power = bm.camera_setup(p)
    f = march_fields(W, rows, ro=ro, fov=p.fov, power=dyn_power,
                     max_iter=p.max_iterations, row0=row0,
                     map_height=map_height, shade=True, device="cpu")
    fields = {k: f[k] for k in bs.PLANES}
    return fields, bs.pack_shade_params(p, ro, dyn_power), p


def test_dispatcher_takes_the_plain_version_on_the_cpu(monkeypatch):
    def no_kernel(*a, **kw):
        raise AssertionError("K4c launched for CPU planes")

    monkeypatch.setattr(bs, "shade_fields_cuda", no_kernel)
    fields, params, p = _sample()
    kw = dict(aa=1, last=True, row0=0, map_height=H,
              palette_mode=p.palette_mode, quantize=8)
    got = bs.shade_fields(fields, None, params, **kw)
    # the plain version computes its scalars and rays when not given
    scalars = bs.upload_scalars(params, "cpu")
    rays = bs.sample_rays(scalars, params, W, H, 0, H)
    want = bs.shade_fields_plain(fields, None, params, scalars=scalars,
                                 rays=rays, **kw)
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    assert torch.equal(got, bs.shade_fields_plain(fields, None, params,
                                                  **kw))
    with pytest.raises(ValueError, match="unsupported device"):
        bs.shade_fields({k: v.to("meta") for k, v in fields.items()}, None,
                        params, **kw)


def test_plain_samples_accumulate_and_finish_once():
    fields, params, p = _sample()
    kw = dict(aa=2, row0=0, map_height=H, palette_mode=0)
    acc = bs.shade_fields_plain(fields, None, params, last=False, **kw)
    assert acc.dtype == torch.float32 and acc.shape == (H, W, 3)
    once = bs.shade_fields_plain(fields, None, params, last=True,
                                 **dict(kw, aa=1))
    twice = bs.shade_fields_plain(fields, acc, params, last=True, **kw)
    # two equal samples: (s + s) / 4 is s / 2, not s
    assert not torch.equal(once, twice)


def test_kernel_wrapper_checks_raise():
    fields, params, p = _sample()
    kw = dict(aa=1, last=True, row0=0, map_height=H, palette_mode=0)
    with pytest.raises(ValueError, match="CUDA device"):
        bs.shade_fields_cuda(fields, None, params, **kw)
    bad = [
        (dict(fields, t=fields["t"][:-1]), params, kw, "plane t"),
        (dict(fields, nx=fields["nx"].t().contiguous().t()), params, kw,
         "plane nx"),
        (dict(fields, ao=fields["ao"].double()), params, kw, "plane ao"),
        (dict(fields, hit=fields["hit"][None]), params, kw, "rows, width"),
        (fields, params.astype(np.float64), kw, "float32"),
        (fields, params[:-1], kw, "shape"),
        (fields, params, dict(kw, palette_mode=6), "palette"),
        (fields, params, dict(kw, quantize=12), "quantize"),
        (fields, params, dict(kw, aa=0), "bad aa"),
        (fields, params, dict(kw, row0=1), "image height"),
    ]
    for f, pr, k, match in bad:
        for impl in (bs.shade_fields_cuda, bs.shade_fields_plain):
            with pytest.raises(ValueError, match=match):
                impl(f, None, pr, **k)
    acc = torch.zeros((W, H, 3)).transpose(0, 1)  # not contiguous
    for impl in (bs.shade_fields_cuda, bs.shade_fields_plain):
        with pytest.raises(ValueError, match="accumulator"):
            impl(fields, acc, params, **kw)


def test_shade_vector_holds_the_sample_scalars_in_f32():
    scene = _scene(time=0.3, color_offset=0.1, color_scale=1.7,
                   antialiasing_samples=3)
    p = mandelbulb._bulb_params(scene)
    ro, dyn_power = bm.camera_setup(p)
    v = bs.pack_shade_params(p, ro, dyn_power, (1 / 3, 2 / 3))
    assert v.dtype == np.float32 and v.shape == (bs.NS,)
    assert list(v[[bs.S_ROX, bs.S_ROY, bs.S_ROZ]]) == list(ro)
    assert v[bs.S_POWER] == dyn_power and v[bs.S_MAXIT] == 16
    assert v[bs.S_OFFX] == np.float32(1 / 3)
    assert v[bs.S_OFFY] == np.float32(2 / 3)
    assert v[bs.S_CSCALE] == np.float32(1.7)


def test_kernel_light_direction_is_pythons_double():
    # K4c folds shade_hit's light direction from this literal as Python
    # does, in double, then rounds each component to f32 once
    with open(os.path.join(_cuda.CSRC_DIR, "bulb.cu")) as f:
        src = f.read()
    lit = re.search(r"constexpr double kLl = ([0-9.e+-]+);", src).group(1)
    assert float(lit) == math.sqrt(1.0 + 1.0 + 0.8 * 0.8)
    assert "kLx = 1.0 / kLl, kLz = 0.8 / kLl;" in src
