"""Training entry point of the port: pretrain / finetune Llama, Falcon and
GPT decoders on one NVIDIA GPU (mirror of the root ``finetune.py``).

The same flags as the JAX entry, resolved into the port's
``RuntimeConfig`` and handed to ``training.driver.pretrain``.  ``--device``
(default ``cuda``) takes the place of the JAX entry's platform selection;
the CPU runs every kernel's plain version.  ``--save`` / ``--load`` /
``--save_interval`` write and resume the port's checkpoints
(``checkpointing.py``); ``--load`` of a release checkpoint (the output of
``tools/checkpoint_util.py hf-to-native``) finetunes imported weights, and
``--use_checkpoint_args`` takes the model, parallel and optimizer config
from the checkpoint.  Data: ``--mock_data``; ``--data_path [W1] P1 [W2
P2 ...]``, one or more weighted ``.bin``/``.idx`` prefixes of
``tools/preprocess_data.py`` split by ``--split`` (GPT samples, blended);
or ``--instruction_data`` with one prefix of its ``_text_document`` /
``_role_document`` pair.  ``--tokenizer_type`` / ``--tokenizer_model``
give the end-of-document id and grow the vocab for extra ids.
``--lora_rank R`` trains a LoRA adapter against the frozen base instead
(``training/lora.py``): the base comes from ``--load`` (the parameters
alone) or a fresh init from the seed (smoke runs only), ``--save``
receives an adapter-only checkpoint at ``<save>/adapter``, and
``--lora_load`` continues an adapter, the port's or a PEFT directory's.
``--tp``, ``--dp``, ``--sequence_parallel``,
``--use_distributed_optimizer``, ``--pp`` (with
``--virtual_pipeline_stages``), ``--cp`` (with ``--cp_layout``) and
``--ep`` train one process a rank under ``torchrun``
(``initialize.initialize_distributed`` joins the world from its
environment; two ranks on one GPU talk over gloo, one rank a GPU over
NCCL); ``--num_experts`` makes the MLPs routed experts (``--moe_top_k``,
``--moe_capacity_factor``, ``--moe_aux_loss_coeff``).  The degrees
combine as JAX's do: ``--pp`` with ``--cp`` (the contiguous layout; the
zigzag layout under pp is JAX's own refusal, its ``config.py:494-498``),
and ``--num_experts`` with ``--cp`` or ``--sequence_parallel``.  What
the port does not have raises ``NotImplementedError`` naming the ROADMAP
item: LoRA or int8 training matmuls under parallelism.

    python -m megatron_llm_tpu_torch.finetune --model tiny --mock_data \\
        --train_iters 10 --device cpu --log_interval 1 --save ckpt
    python -m megatron_llm_tpu_torch.finetune --model tiny --mock_data \
        --lora_rank 8 --train_iters 10 --device cpu --save lora_out
    python -m megatron_llm_tpu_torch.finetune --model llama2 \\
        --data_path 0.7 corpusA_text_document 0.3 corpusB_text_document \\
        --tokenizer_type gpt2-bpe --tokenizer_model VOCAB_DIR ...
    torchrun --nproc_per_node 2 -m megatron_llm_tpu_torch.finetune \
        --model llama2 --tp 2 --sequence_parallel --mock_data ...
    torchrun --nproc_per_node 2 -m megatron_llm_tpu_torch.finetune \
        --model llama2 --pp 2 --global_batch_size 8 --mock_data ...
    torchrun --nproc_per_node 2 -m megatron_llm_tpu_torch.finetune \
        --model llama2 --num_experts 8 --ep 2 --mock_data ...
    torchrun --nproc_per_node 4 -m megatron_llm_tpu_torch.finetune \
        --model llama2 --pp 2 --cp 2 --global_batch_size 4 --mock_data ...
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)

    g = p.add_argument_group("model")
    g.add_argument("--model", default="llama2",
                   choices=["llama", "llama2", "llama3", "llama3.1",
                            "codellama", "falcon", "gpt", "tiny"])
    g.add_argument("--model_size", default="7b")
    g.add_argument("--seq_length", type=int, default=None)
    g.add_argument("--rope_scaling_factor", type=float, default=1.0)
    g.add_argument("--rope_scaling_type", default=None,
                   choices=["linear", "llama3", "yarn"])
    g.add_argument("--rope_original_max_positions", type=int, default=None)
    g.add_argument("--num_experts", type=int, default=0)
    g.add_argument("--moe_top_k", type=int, default=2)
    g.add_argument("--moe_capacity_factor", type=float, default=1.25)
    g.add_argument("--moe_aux_loss_coeff", type=float, default=0.01)
    g.add_argument("--params_dtype", default="bfloat16",
                   choices=["float32", "bfloat16", "float16"])
    g.add_argument("--attention_impl", default="flash",
                   choices=["flash", "dot"])
    g.add_argument("--recompute", default="selective",
                   choices=["none", "selective", "full"])
    g.add_argument("--quantize_matmuls", default="none",
                   choices=["none", "int8"])
    g.add_argument("--hidden_dropout", type=float, default=None)
    g.add_argument("--lima_dropout", action="store_true")
    g.add_argument("--drop_path_rate", type=float, default=0.0)

    g = p.add_argument_group("lora")
    g.add_argument("--lora_rank", type=int, default=0,
                   help="train a LoRA adapter of this rank against the "
                        "frozen base model instead of full finetuning "
                        "(0 = off); checkpoints are adapter-only")
    g.add_argument("--lora_targets", nargs="*", default=None,
                   help="projections to adapt (default: wq wv); choose "
                        "from wq wk wv wo w_gate w_up w_down")
    g.add_argument("--lora_alpha", type=float, default=None,
                   help="LoRA alpha (default: rank, i.e. scale 1.0)")
    g.add_argument("--lora_load", default=None,
                   help="continue this adapter: a directory written by "
                        "--save (<save>/adapter) or a PEFT adapter "
                        "directory (adapter_config.json and "
                        "adapter_model.safetensors or .bin)")

    g = p.add_argument_group("parallelism")
    g.add_argument("--tp", "--tensor_parallel", type=int, default=1,
                   dest="tp")
    g.add_argument("--pp", "--pipeline_parallel", type=int, default=1,
                   dest="pp")
    g.add_argument("--dp", "--data_parallel", type=int, default=1, dest="dp")
    g.add_argument("--ep", "--expert_parallel", type=int, default=1)
    g.add_argument("--cp_layout", "--context_parallel_layout",
                   default="contiguous", choices=["contiguous", "zigzag"])
    g.add_argument("--cp", "--context_parallel", type=int, default=1,
                   dest="cp")
    g.add_argument("--virtual_pipeline_stages", type=int, default=1)
    g.add_argument("--pipeline_remat_window", type=int, default=0)
    g.add_argument("--sequence_parallel", action="store_true")
    g.add_argument("--use_distributed_optimizer", action="store_true")

    g = p.add_argument_group("training")
    g.add_argument("--train_iters", type=int, default=1000)
    g.add_argument("--micro_batch_size", type=int, default=1)
    g.add_argument("--global_batch_size", type=int, default=1)
    g.add_argument("--rampup_batch_size", type=int, nargs=3, default=None)
    g.add_argument("--seed", type=int, default=1234)
    g.add_argument("--lr", type=float, default=3e-4)
    g.add_argument("--min_lr", type=float, default=3e-5)
    g.add_argument("--lr_decay_style", default="cosine",
                   choices=["constant", "linear", "cosine",
                            "inverse-square-root"])
    g.add_argument("--lr_warmup_iters", type=int, default=0)
    g.add_argument("--weight_decay", type=float, default=0.1)
    g.add_argument("--clip_grad", type=float, default=1.0)
    g.add_argument("--adam_beta1", type=float, default=0.9)
    g.add_argument("--adam_beta2", type=float, default=0.95)
    g.add_argument("--optimizer", default="adamw", choices=["adamw", "sgd"])
    g.add_argument("--skip_iters", type=int, nargs="*", default=())

    g = p.add_argument_group("checkpointing")
    g.add_argument("--save", default=None)
    g.add_argument("--load", default=None)
    g.add_argument("--save_interval", type=int, default=1000)
    g.add_argument("--use_checkpoint_args", action="store_true")

    g = p.add_argument_group("data")
    g.add_argument("--data_path", nargs="*", default=None,
                   help="corpus prefix(es), optionally weighted: "
                        "[w1 prefix1 w2 prefix2 ...]")
    g.add_argument("--split", default="969,30,1")
    g.add_argument("--instruction_data", action="store_true",
                   help="role-tagged instruction dataset (one prefix of "
                        "its _text_document / _role_document pair)")
    g.add_argument("--scalar_loss_mask", type=float, default=0.0)
    g.add_argument("--mock_data", action="store_true",
                   help="synthetic random tokens from the seed")
    g.add_argument("--data_cache_dir", default=None)

    g = p.add_argument_group("tokenizer")
    g.add_argument("--tokenizer_type", default="null")
    g.add_argument("--tokenizer_model", default=None)
    g.add_argument("--vocab_extra_ids_list", nargs="*", default=None)

    g = p.add_argument_group("eval/logging")
    g.add_argument("--eval_interval", type=int, default=1000)
    g.add_argument("--eval_iters", type=int, default=10)
    g.add_argument("--log_interval", type=int, default=10)
    g.add_argument("--metrics", nargs="*", default=())
    g.add_argument("--tensorboard_dir", default=None)
    g.add_argument("--wandb_project", default=None)
    g.add_argument("--wandb_name", default=None)
    g.add_argument("--profile_dir", default=None)
    g.add_argument("--profile_step_start", type=int, default=11)
    g.add_argument("--profile_step_end", type=int, default=13)
    g.add_argument("--exit_interval", type=int, default=None)
    g.add_argument("--exit_duration_mins", type=float, default=None)

    g = p.add_argument_group("device")
    g.add_argument("--device", default="cuda",
                   help="torch device to train on (the tests pass 'cpu')")
    return p.parse_args(argv)


def build_config(args):
    from .config import (
        OptimizerConfig,
        ParallelConfig,
        RuntimeConfig,
        TrainConfig,
        codellama_config,
        falcon_config,
        gpt_config,
        llama1_config,
        llama2_config,
        llama3_config,
        llama31_config,
        tiny_config,
    )

    overrides = dict(
        params_dtype=args.params_dtype,
        attention_impl=args.attention_impl,
        recompute=args.recompute,
        quantize_matmuls=args.quantize_matmuls,
    )
    if args.seq_length:
        overrides["seq_length"] = args.seq_length
    if args.rope_scaling_factor != 1.0:
        overrides["rope_scaling_factor"] = args.rope_scaling_factor
    if args.rope_scaling_type:
        overrides["rope_scaling_type"] = args.rope_scaling_type
    if args.rope_original_max_positions:
        overrides["rope_original_max_positions"] = \
            args.rope_original_max_positions
    if args.hidden_dropout is not None:
        overrides["hidden_dropout"] = args.hidden_dropout
    if args.lima_dropout:
        if not args.hidden_dropout:
            raise SystemExit(
                "--lima_dropout ramps 0 -> hidden_dropout across layers, "
                "but hidden_dropout is 0 (the preset default) - pass a "
                "nonzero --hidden_dropout for it to have any effect")
        overrides["lima_dropout"] = True
    if args.drop_path_rate:
        overrides["drop_path_rate"] = args.drop_path_rate
    if args.num_experts:
        overrides.update(
            num_experts=args.num_experts, moe_top_k=args.moe_top_k,
            moe_capacity_factor=args.moe_capacity_factor,
            moe_aux_loss_coeff=args.moe_aux_loss_coeff)
    builders = {
        "llama": lambda: llama1_config(args.model_size, **overrides),
        "llama2": lambda: llama2_config(args.model_size, **overrides),
        "llama3": lambda: llama3_config(args.model_size, **overrides),
        "llama3.1": lambda: llama31_config(args.model_size, **overrides),
        "codellama": lambda: codellama_config(args.model_size, **overrides),
        "falcon": lambda: falcon_config(args.model_size, **overrides),
        "gpt": lambda: gpt_config(args.model_size, **overrides),
        "tiny": lambda: tiny_config(**overrides),
    }
    model = builders[args.model]()
    if args.rope_scaling_type and model.rope_scaling_factor == 1.0:
        raise SystemExit(
            "--rope_scaling_type has no effect with rope_scaling_factor=1.0 "
            "— pass --rope_scaling_factor (or a preset that sets one)")

    parallel = ParallelConfig(
        data_parallel=args.dp,
        pipeline_parallel=args.pp,
        tensor_parallel=args.tp,
        context_parallel=args.cp,
        context_parallel_layout=args.cp_layout,
        expert_parallel=args.ep,
        virtual_pipeline_stages=args.virtual_pipeline_stages,
        pipeline_remat_window=args.pipeline_remat_window,
        sequence_parallel=args.sequence_parallel,
        use_distributed_optimizer=args.use_distributed_optimizer,
        num_microbatches=max(
            1, args.global_batch_size // (args.micro_batch_size * args.dp)),
    )
    optimizer = OptimizerConfig(
        optimizer=args.optimizer,
        lr=args.lr,
        min_lr=args.min_lr,
        weight_decay=args.weight_decay,
        adam_beta1=args.adam_beta1,
        adam_beta2=args.adam_beta2,
        clip_grad=args.clip_grad,
        lr_decay_style=args.lr_decay_style,
        lr_warmup_iters=args.lr_warmup_iters,
    )
    train = TrainConfig(
        train_iters=args.train_iters,
        micro_batch_size=args.micro_batch_size,
        global_batch_size=args.global_batch_size,
        rampup_batch_size=tuple(args.rampup_batch_size)
        if args.rampup_batch_size else None,
        seq_length=args.seq_length or model.seq_length,
        seed=args.seed,
        eval_interval=args.eval_interval,
        eval_iters=args.eval_iters,
        save=args.save,
        load=args.load,
        save_interval=args.save_interval,
        log_interval=args.log_interval,
        tensorboard_dir=args.tensorboard_dir,
        wandb_project=args.wandb_project,
        wandb_name=args.wandb_name,
        exit_interval=args.exit_interval,
        profile_dir=args.profile_dir,
        profile_step_start=args.profile_step_start,
        profile_step_end=args.profile_step_end,
        exit_duration_mins=args.exit_duration_mins,
        data_path=args.data_path,
        split=args.split,
        metrics=tuple(args.metrics),
        skip_iters=tuple(args.skip_iters),
    )
    cfg = RuntimeConfig(model=model, parallel=parallel, optimizer=optimizer,
                        train=train)
    # --use_checkpoint_args: the checkpoint's config wins but for the
    # training section (reference checkpointing.py:476-559)
    if args.use_checkpoint_args and args.load:
        from .checkpointing import load_config_from_checkpoint

        saved = load_config_from_checkpoint(args.load)
        cfg = RuntimeConfig(model=saved.model, parallel=saved.parallel,
                            optimizer=saved.optimizer, train=train)
    return cfg.validate()


class _MockDataset:
    """Deterministic random-token dataset (the JAX entry's, sample for
    sample: sample ``i`` comes from ``default_rng(seed + i)``)."""

    def __init__(self, vocab_size: int, seq_length: int, n: int = 4096,
                 seed: int = 0):
        self.vocab = vocab_size
        self.seq = seq_length
        self.n = n
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed + idx)
        return {"text": rng.integers(0, self.vocab,
                                     self.seq + 1).astype("int64")}


def build_datasets(args, cfg):
    """``(train, valid, test)`` (JAX ``finetune.py:339-383``): mock data,
    instruction data from one prefix, or GPT datasets from each weighted
    prefix, blended where more than one prefix gives a split."""
    from .data.blendable_dataset import BlendableDataset, parse_data_paths
    from .data.gpt_dataset import build_gpt_datasets
    from .data.instruction_dataset import build_instruction_datasets

    if args.mock_data:
        ds = _MockDataset(cfg.model.vocab_size, cfg.train.seq_length)
        return ds, _MockDataset(cfg.model.vocab_size, cfg.train.seq_length,
                                n=256, seed=10_000), None
    if not args.data_path:
        raise SystemExit("--data_path or --mock_data required")

    if args.instruction_data:
        if len(args.data_path) != 1:
            raise SystemExit("instruction data takes a single prefix")
        return build_instruction_datasets(
            args.data_path[0], args.split, cfg.train.seq_length,
            cfg.train.seed, scalar_loss_mask=args.scalar_loss_mask)

    weights, prefixes = parse_data_paths(args.data_path)
    total_samples = cfg.train.train_iters * cfg.train.global_batch_size
    eval_samples = cfg.train.eval_iters * cfg.train.global_batch_size
    nums = [total_samples, eval_samples, eval_samples]
    per_prefix = [
        build_gpt_datasets(prefix, args.split, nums, cfg.train.seq_length,
                           cfg.train.seed, args.data_cache_dir)
        for prefix in prefixes
    ]
    out = []
    for i in range(3):
        # keep the weights aligned with the prefixes that gave this split
        pairs = [(p[i], w) for p, w in zip(per_prefix, weights)
                 if p[i] is not None]
        if not pairs:
            out.append(None)
        elif len(pairs) == 1:
            out.append(pairs[0][0])
        else:
            out.append(BlendableDataset(
                [d for d, _ in pairs], [w for _, w in pairs], nums[i]))
    return tuple(out)


def load_lora_adapter(path: str, model_cfg, device):
    """An adapter directory: the port's / JAX's ``save_adapter`` format
    (``adapter.npz``), else a PEFT one (``tools/hf_interop.
    load_peft_adapter``)."""
    import os

    from .ops.lora import load_adapter
    from .tools.hf_interop import load_peft_adapter

    if os.path.exists(os.path.join(path, "adapter.npz")):
        return load_adapter(path, device=device)
    return load_peft_adapter(path, model_cfg, device=device)


def lora_main(args, cfg, train_ds, eod) -> int:
    """``--lora_rank``: adapter-only finetuning against a frozen base
    (JAX ``finetune.py:431-454``)."""
    from . import checkpointing
    from .models import model as model_lib
    from .training.driver import print_rank_0
    from .training.lora import lora_finetune

    if cfg.train.load:
        base = checkpointing.load_params_for_inference(
            cfg.train.load, cfg.model, device=args.device)
        print_rank_0(f" loaded frozen base from {cfg.train.load}")
    else:
        print_rank_0(" no --load: LoRA against a fresh random base "
                     "(smoke runs only)")
        base = model_lib.init_params(cfg.model, seed=cfg.train.seed,
                                     device=args.device)
    adapter = None
    if args.lora_load:
        adapter = load_lora_adapter(args.lora_load, cfg.model, args.device)
        print_rank_0(f" continuing adapter {args.lora_load} "
                     f"(rank {adapter.rank})")
    lora_finetune(cfg, base, train_ds, rank=args.lora_rank,
                  targets=args.lora_targets, alpha=args.lora_alpha,
                  adapter=adapter, eod_token=eod, save=cfg.train.save)
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    from .initialize import initialize_distributed

    initialize_distributed(args.device)  # a no-op outside a launcher
    cfg = build_config(args)

    from .training.driver import pretrain, print_rank_0

    eod = None
    if args.tokenizer_type and args.tokenizer_type != "null" \
            and args.tokenizer_model:
        from .tokenizer.tokenizer import build_tokenizer

        # extra ids as "--vocab_extra_ids_list a b" or "a,b"
        extra = args.vocab_extra_ids_list
        if extra:
            extra = [t for item in extra for t in item.split(",") if t]
        tok = build_tokenizer(args.tokenizer_type, args.tokenizer_model,
                              extra)
        eod = tok.eod
        if tok.vocab_size > cfg.model.vocab_size:
            # extra special tokens grew the tokenizer past the preset's
            # vocab: grow the embedding so the new ids are real rows
            import dataclasses

            from .config import RuntimeConfig

            cfg = RuntimeConfig(
                model=dataclasses.replace(cfg.model,
                                          vocab_size=tok.vocab_size),
                parallel=cfg.parallel, optimizer=cfg.optimizer,
                train=cfg.train).validate()
            print_rank_0(f" vocab grown to {tok.vocab_size} "
                         f"(tokenizer extra ids)")

    print_rank_0(f"model: {args.model} {args.model_size} "
                 f"({cfg.model.num_layers} layers) | device: {args.device} | "
                 f"gbs={cfg.train.global_batch_size} "
                 f"seq={cfg.train.seq_length}")
    train_ds, valid_ds, test_ds = build_datasets(args, cfg)
    if args.lora_rank:
        return lora_main(args, cfg, train_ds, eod)
    pretrain(cfg, train_ds, valid_ds, test_ds, eod_token=eod,
             device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
