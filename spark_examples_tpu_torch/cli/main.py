"""CLI: ``python -m spark_examples_tpu_torch.cli.main pca [flags]``.

The ``pca`` subcommand of the JAX package's CLI, on PyTorch, against an
on-disk JSONL cohort (``--input-path <dir>``: the same directory and CSR
sidecar the JAX package's CLI reads) or the hermetic synthetic cohort
(``--fixture-*`` flags). Computes on the card by default; ``--device cpu``
runs on the CPU.
"""

from __future__ import annotations

import argparse
import sys

from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    synthetic_cohort,
)
from spark_examples_tpu_torch.genomics.shards import references_for_all
from spark_examples_tpu_torch.genomics.sources import JsonlSource
from spark_examples_tpu_torch.utils.config import (
    add_pca_flags,
    pca_config_from_args,
    unported,
)

__all__ = ["build_parser", "main"]


def _add_fixture_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--fixture-samples",
        type=int,
        default=None,
        help="Run against an in-memory synthetic cohort of this many samples",
    )
    p.add_argument("--fixture-variants", type=int, default=1000)
    p.add_argument("--fixture-seed", type=int, default=0)
    p.add_argument(
        "--fixture-sparse-calls",
        action="store_true",
        help="Omit hom-ref calls from generated records (~10x faster at "
        "large N x V; identical pipeline results)",
    )
    p.add_argument(
        "--fixture-rare-af",
        type=float,
        default=None,
        help="Cap generated variants' allele frequency near this value "
        "(rare-variant biobank shape, ~98%% zeros at 0.01; group AFs "
        "drawn in [0.5x, 1.5x) so population structure survives); "
        "default keeps the common-variant beta draw",
    )


def _offline_source(args, references: str):
    """JSONL-dir or synthetic-fixture source, or None if neither flagged."""
    if args.input_path:
        return JsonlSource(args.input_path)
    if args.fixture_samples:
        return synthetic_cohort(
            args.fixture_samples,
            args.fixture_variants,
            references=references,
            seed=args.fixture_seed,
            sparse_calls=args.fixture_sparse_calls,
            rare_variant_af=args.fixture_rare_af,
            variant_set_id=(
                args.variant_set_ids or [DEFAULT_VARIANT_SET_ID]
            )[0],
        )
    return None


def _cmd_pca(args) -> int:
    from spark_examples_tpu_torch.models.pca import VariantsPcaDriver

    if args.api_url:
        raise unported("--api-url", "slice 6, the network tier of item 8")
    conf = pca_config_from_args(args)
    if not args.variant_set_ids:
        conf.variant_set_ids = [DEFAULT_VARIANT_SET_ID]
    source = _offline_source(
        args,
        # Cover exactly what an --all-references manifest queries.
        references_for_all() if conf.all_references else conf.references,
    )
    if source is None:
        raise SystemExit(
            "No data source: pass --input-path <jsonl cohort dir> or "
            "--fixture-samples N (the network source is not ported yet)"
        )
    VariantsPcaDriver(conf, source).run()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="spark_examples_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    pca = sub.add_parser("pca", help="VariantsPcaDriver: PCoA over a cohort")
    add_pca_flags(pca)
    _add_fixture_flags(pca)
    pca.set_defaults(fn=_cmd_pca)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
