"""A cell of the benchmark at widths a CPU test can hold: the cell's own
configuration and mix with the denoiser at hidden 128/256/128, T = 12 (or
DDIM over 4), a 30-patient cohort at 10/40/14 and the calibration forced
onto the tensors' device ("device": the CPU here)."""

from __future__ import annotations

import copy

import torch

from benchmark.harness import load_cell

TINY_COHORT = {"patients": 30, "mutation_genes": 10, "expression_genes": 40, "pathways": 14}


def tiny_cell(name: str, rows: int = 300, check_rows: int = 64):
    cell = copy.deepcopy(load_cell(name))
    conf = cell.config["config"]
    conf["model"]["hidden_dims"] = [128, 256, 128]
    conf["model"]["diffusion"]["num_steps"] = 12
    conf["generation"]["sampling_steps"] = 4
    conf["generation"]["calibration_backend"] = "device"
    cell.config["cohort"] = dict(TINY_COHORT)
    cell.traffic = dict(cell.traffic, rows=rows, check_rows=check_rows)
    return cell


def cpu():
    torch.set_num_threads(2)
    return torch.device("cpu")
