"""Writes a CVS dataset (the port's ``cvs.npz``) as the reference's four
``torch.save`` pickles, the files ``data/cvs.py::load_reference_pickles``
reads: ``processed_data.pkl``, ``train_params_data.pkl``,
``test_params_data.pkl`` and, with ``norm``, ``data_norm_params.pkl``."""

import os

import numpy as np
import torch


def write_reference_pickles(npz: str, out_dir: str, norm: bool = True) -> str:
    os.makedirs(out_dir, exist_ok=True)
    with np.load(npz) as z:
        d = {k: z[k] for k in z.files}
    torch.save({"train": torch.from_numpy(d["train_obs"]), "test": torch.from_numpy(d["test_obs"])},
               os.path.join(out_dir, "processed_data.pkl"))
    for split in ("train", "test"):
        torch.save({"i_ext": d[f"{split}_iext"], "r_tpr_mod": d[f"{split}_rtpr"]},
                   os.path.join(out_dir, f"{split}_params_data.pkl"))
    if norm:
        torch.save({k[len("norm_"):]: v for k, v in d.items() if k.startswith("norm_")},
                   os.path.join(out_dir, "data_norm_params.pkl"))
    return out_dir
