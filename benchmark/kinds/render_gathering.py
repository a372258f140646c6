"""render_gathering: NeuMan's telegathering as `render_gathering.run`
renders it, through `render_hybrid_nerf_multi_persons` with the script's
arguments (its chunk, samples, KNN stride, default knn_k and bf16, one
topology for every actor).

The configuration's `actors` are placed by the preset's translations less
the first actor's, over the preset's scale, in body units, about the
inputs' body at the origin. Each actor has its own canonical net and its
own betas, drawn from the seed after the inputs every cell draws (the
background pair, the first actor's canonical net and the offset net, then
the video's betas and motion, which are the first actor's): then a
canonical net and ten betas an actor, in the actors' order. Every actor
takes the same pose. The cameras are the script's `read_novel_caps`: the
video's frame `base_frame` (at most its last), moved on an ellipse along
its own right and up axes, `ellipse_turns` turns over `cameras` frames,
its orientation kept; camera i takes pose i of the motion.

`hits(i)` and `work()` count each actor's net on the rays its own sphere
test passes (the background on every ray): the work the model needs. The
rows of the union that the program hands an actor it misses (placeholders)
are not counted, so the roofline and the MFU read the same work however the
program routes the rays; `placeholder_pct.render` reads their share.
"""

import math
import random
import sys

import numpy as np
import torch

from benchmark import cells, inputs
from benchmark.reference import gathering as gathering_ref
from benchmark.reference import mesh as mesh_ref
from benchmark.reference import smpl as smpl_ref
from neuman_tpu_torch.models import human_nerf as hn
from neuman_tpu_torch.ops import mesh as mesh_ops
from neuman_tpu_torch.render import renderer


def canonical_weights(cfg, gen, alpha_bias=0.5):
    """A canonical net's weights, drawn as `inputs.weights` draws each net:
    one `torch.rand` call, nn.Linear's U(+-1/sqrt(fan_in)), the density
    head's bias at `alpha_bias`."""
    shapes = inputs.net_shapes(cfg, "can")
    flat = torch.rand(sum(math.prod(s) for _, s, _ in shapes), generator=gen, device=gen.device)
    ws, at = {}, 0
    for name, shape, fan in shapes:
        n = math.prod(shape)
        ws[name] = ((flat[at:at + n] * 2.0 - 1.0) / math.sqrt(fan)).reshape(shape)
        at += n
    ws["alpha_linear.bias"].fill_(alpha_bias)
    return ws


def layout(actors):
    """[A, 3] offsets of the actors in body units: the preset's
    translations less the first actor's, over the preset's scale."""
    t = np.asarray(actors["translations"], np.float64)
    return (t - t[0]) / actors["scale"]


def ellipse_cameras(c2w, count, right, up, turns):
    """[count, 4, 4] cameras: `c2w` moved by `right` along its right axis
    (column 0) times cos and by `up` along its up axis (minus column 1)
    times sin of `turns` turns over the frames; orientation kept."""
    out = c2w[None].repeat(count, 1, 1)
    for i in range(count):
        a = i / count * turns * 2.0 * math.pi
        out[i, :3, 3] += right * math.cos(a) * c2w[:3, 0] - up * math.sin(a) * c2w[:3, 1]
    return out


class Runner(cells.RenderRunner):
    """`render_hybrid_nerf_multi_persons` over the gathering's camera path."""

    work = cells.RenderHybrid.work

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        dev = self.device
        gen = inputs.generator(self.seed, dev)
        self.w0 = inputs.weights(self.c, gen, inputs.NETS)
        self.body = inputs.body(dev)
        self.fr = inputs.frames(traffic, gen, self.body)
        self.geo = self.fr["bone"]
        cans, betas = [self.w0["can"]], [self.fr["betas"]]
        for _ in cfg["actors"]["names"][1:]:
            cans.append(canonical_weights(self.c, gen))
            betas.append(torch.randn(10, generator=gen, device=dev))
        self.ncfg = cells.port_config(cfg, render=True)
        self.spec = hn.build_human_nerf_spec(self.ncfg)
        self.model = hn.HumanNeRF(self.spec, device=dev)
        for net, mod in (("bkg_coarse", self.model.coarse_bkg_net), ("bkg_fine", self.model.fine_bkg_net)):
            mod.nerf.load_state_dict(self.w0[net])
        self.models = []
        for w in cans:
            m = hn.HumanNeRF(self.spec, device=dev)
            m.coarse_human_net.nerf.load_state_dict(w)
            self.models.append(m.requires_grad_(False))
        self.model.requires_grad_(False)
        self.faces = self.body["faces"].cpu().numpy()
        self.topo = mesh_ops.MeshTopology.build(self.faces, self.body["v_template"].shape[0], dev)
        count, n = traffic["cameras"], traffic["frames"]
        base = self.fr["c2w"][min(traffic["base_frame"], n - 1)]
        c2w = ellipse_cameras(base, count, traffic["ellipse_right"], traffic["ellipse_up"],
                              traffic["ellipse_turns"])
        k = self.fr["k"][0]
        self.cams = [(k, c2w[i]) for i in range(count)]
        self.caps = [self._cap(*cam) for cam in self.cams]
        self.actors = []
        for can, beta, off in zip(cans, betas, layout(cfg["actors"])):
            off = torch.as_tensor(off, dtype=torch.float32, device=dev)
            verts, ts = [], []
            for i in range(count):
                v, t, _ = smpl_ref.da_to_posed(self.body, beta, self.fr["poses"][i % n])
                t[:, :3, 3] += off
                verts.append(v + off)
                ts.append(t)
            self.actors.append({"can": can, "verts": torch.stack(verts), "ts": torch.stack(ts)})
        self.kept, self.done, self.order = [], 0, []
        self.rng = random.Random(self.seed)
        self.unit()
        self.kept, self.done, self.order = [], 0, []
        cells._sync(dev)

    def _frame(self, i):
        c, n = self.c, len(self.actors)
        return renderer.render_hybrid_nerf_multi_persons(
            self.spec, self.model, self.caps[i], [self.spec] * n, self.models,
            [a["verts"][i] for a in self.actors], [self.faces] * n, [a["ts"][i] for a in self.actors],
            self.device, importance_samples_per_ray=c["importance_samples_per_ray"], geo_threshold=self.geo,
            rays_per_batch=c["render_rays_per_batch"], samples_per_ray=c["samples_per_ray"],
            knn_stride=c["knn_stride"], topologies=[self.topo] * n)[0]

    def release(self):
        self.models = None
        super().release()

    def _reference(self, i, rays, prec):
        faces = self.body["faces"]
        inc = mesh_ref.incidence(faces, self.body["v_template"].shape[0])
        actors = [{"can": a["can"], "verts": a["verts"][i], "ts": a["ts"][i], "faces": faces, "inc": inc}
                  for a in self.actors]
        return gathering_ref.gathering(self.w0, actors, *rays, self.traffic["bkg_near"],
                                       self.traffic["bkg_far"], self.geo, self.c, prec)

    def check(self, control=None):
        """The render runners' check; `crossing` counts the checked rays
        that pass two or more actors."""
        self.crossing = 0
        out = super().check(control)
        print(f"{self.crossing} of the checked rays pass two or more actors", file=sys.stderr)
        return out

    def _check_rays(self, i):
        """(pixel ids, their rays) of frame i that the check renders: half
        over the frame, half over the union of the actors' hits, less the
        rays whose hit test f32 cannot settle for some actor; `crossing`
        adds the kept rays that pass two or more actors."""
        o, d = self._pixels(i)
        union = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        for a in self.actors:
            union |= self._passes(o, d, a["verts"][i])
        px = self._sample_rays(i, union)
        keep = torch.ones(px.shape[0], dtype=torch.bool, device=o.device)
        passes = torch.zeros(px.shape[0], dtype=torch.int64, device=o.device)
        for a in self.actors:
            keep &= ~mesh_ref.unsettled(o[px], d[px], a["verts"][i], self.geo)
            near, far = mesh_ref.near_far(o[px], d[px], a["verts"][i], self.geo)
            passes += (near < far).long()
        self.unsettled += int((~keep).sum())
        self.crossing += int(((passes >= 2) & keep).sum())
        px = px[keep]
        return px, (o[px], d[px])

    @torch.no_grad()
    def _passes(self, o, d, v):
        """[N] whether each ray passes within the radius of a vertex of `v`
        (the render runners' `hits` test: products in f32, TF32 off)."""
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        out = []
        for oc, dc in zip(o.split(32768), d.split(32768)):
            z0 = dc @ v.T - (dc * oc).sum(-1, keepdim=True)
            dist2 = (v * v).sum(-1)[None] - 2.0 * (oc @ v.T) + (oc * oc).sum(-1, keepdim=True)
            out.append(((dist2 - z0**2) <= self.geo**2).any(1))
        torch.backends.cuda.matmul.allow_tf32 = saved
        return torch.cat(out)

    def hits(self, i):
        """The sum over the actors of frame i's rays that pass within the
        radius of one of the actor's vertices."""
        o, d = self._pixels(i)
        return sum(int(self._passes(o, d, a["verts"][i]).sum()) for a in self.actors)
