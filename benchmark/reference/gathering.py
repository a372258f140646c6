"""NeuMan's telegathering (arXiv:2203.12575; apple/ml-neuman
render_gathering.py), plain: several actors rendered together in one
background.

Per chunk of `render.CHUNK` rays: the background's coarse -> importance ->
fine pass on every ray; on each ray, the human branch (`render._human`:
samples between the actor's near and far, the warp by its frame's
per-vertex transforms, its canonical net) of every actor whose own sphere
test the ray passes, and of no other actor; then one merge by z of the
background's samples and those actors', and one integration.

The program runs each actor's branch on every ray that passes any actor
and gives the rays that miss that actor placeholder samples (z ~1e8,
sigma -1e9). They are dropped here: relu(sigma) = 0 gives them no weight,
and they lie behind every real sample.
"""

import torch

from benchmark.reference import F32
from benchmark.reference import mesh as mesh_ref
from benchmark.reference import nerf as nerf_ref
from benchmark.reference.render import CHUNK, _human


@torch.no_grad()
def gathering(bkg, actors, o, d, bkg_near, bkg_far, radius, cfg, prec=F32):
    """rgb [N, 3] of the rays (o, d) through the scene: `bkg` holds the
    background's nets ("bkg_coarse", "bkg_fine"); each actor is a dict of
    its canonical net ("can"), its posed vertices ("verts" [V, 3]), their
    transforms ("ts" [V, 4, 4]), its faces ("faces" [F, 3]) and their
    incidence ("inc", `mesh.incidence` of this package)."""
    out = []
    with prec.scope():
        for oc, dc in zip(o.split(CHUNK), d.split(CHUNK)):
            n = oc.shape[0]
            fz, fs, frgb = nerf_ref.background(
                bkg["bkg_coarse"], bkg["bkg_fine"], oc, dc, torch.full((n, 1), bkg_near, device=o.device),
                torch.full((n, 1), bkg_far, device=o.device), cfg["samples_per_ray"],
                cfg["importance_samples_per_ray"], prec, cfg["dir_N_freqs"], cfg["pos_N_freqs"])
            dn = torch.linalg.norm(dc, dim=-1)
            rgb = nerf_ref.integrate(fs, frgb, fz, dn, True)[0]
            # each actor's samples on the rays that pass its own spheres
            passes, samples = torch.zeros(n, dtype=torch.int64, device=o.device), []
            for k, a in enumerate(actors):
                near, far = mesh_ref.near_far(oc, dc, a["verts"], radius)
                hit = torch.nonzero(near < far).squeeze(1)
                passes[hit] += 1 << k
                samples.append((hit, _human(a["can"], oc[hit], dc[hit], near[hit], far[hit], a["verts"],
                                            a["ts"], a["faces"], a["inc"], cfg, prec)
                                if hit.numel() else None))
            # the rays that pass the same actors: one merge over their sets
            for code in torch.unique(passes).tolist():
                if not code:
                    continue
                rows = torch.nonzero(passes == code).squeeze(1)
                zs, sigmas, rgbs = [fz[rows]], [fs[rows]], [frgb[rows]]
                for k, (hit, human) in enumerate(samples):
                    if code >> k & 1:
                        at = torch.searchsorted(hit, rows)  # the rows' places in the actor's hits
                        zs.append(human[0][at])
                        sigmas.append(human[1][at])
                        rgbs.append(human[2][at])
                mz, ms, mrgb = nerf_ref.merge(zs, sigmas, rgbs)
                rgb[rows] = nerf_ref.integrate(ms, mrgb, mz, dn[rows], True)[0]
            out.append(rgb)
    return torch.cat(out)
