"""Cells at sizes a CPU test run holds: the program's test-scale models
(``llama-moe-tiny``, ``bert-tiny``: f32, dense attention) under a cell's
limits, with their configuration written out for the reference."""

from __future__ import annotations

from perfbench import spec

MOE = {
    "name": "llama-moe-tiny", "family": "mixtral",
    "hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "num_hidden_layers": 2,
    "num_local_experts": 4, "num_experts_per_tok": 2, "vocab_size": 256,
    "rope_theta": 500000.0, "rms_norm_eps": 1e-05,
    "router_aux_loss_coef": 0.01, "assumed": {"capacity_factor": 1.25},
    "trainer": ["--model", "llama-moe-tiny", "--lr", "3e-4"],
    "optimizer": {"lr": 0.0003, "betas": [0.9, 0.999], "eps": 1e-08,
                  "weight_decay": 0.0001},
}

BERT = {
    "name": "bert-tiny", "family": "bert",
    "hidden_size": 32, "intermediate_size": 64, "num_attention_heads": 2,
    "num_hidden_layers": 2, "vocab_size": 128, "max_position_embeddings": 64,
    "type_vocab_size": 2, "layer_norm_eps": 1e-12,
    "trainer": ["--model", "bert-tiny", "--mlm-layout", "positions",
                "--lr", "1e-4"],
    "optimizer": {"lr": 0.0001, "betas": [0.9, 0.999], "eps": 1e-08,
                  "weight_decay": 0.0001},
}

TRAFFIC = {
    "mixtral": {"seq_len": 32, "global_batch": 4, "grad_accum": 2,
                "corpus_sequences": 64, "tokens": "uniform"},
    "bert": {"seq_len": 32, "global_batch": 8, "grad_accum": 1,
             "corpus_sequences": 64, "tokens": "uniform"},
}

# The cell whose limits each tiny cell is held to.
LIMITS_OF = {"mixtral": "mixtral-2l.pretrain-s4096",
             "bert": "bert-base.phase2-s512"}


def cell(family: str, benchmark_cell=None) -> spec.Cell:
    """A tiny cell of ``family`` held to ``benchmark_cell``'s limits and
    metrics (default ``LIMITS_OF[family]``)."""
    real = spec.load(benchmark_cell or LIMITS_OF[family])
    config = MOE if family == "mixtral" else BERT
    workload = dict(real.workload, config=config["name"], traffic="tiny")
    return spec.Cell(f"{config['name']}.tiny", workload, config,
                     TRAFFIC[family], real.end_to_end, real.per_layer)
