"""CLI: ``python -m spark_examples_tpu_torch.cli.main <command> [flags]``.

The JAX package's CLI on PyTorch, for the commands the port serves so far:

- ``pca`` against a genomics service (``--api-url http(s)://`` or
  ``grpc://``, mirrored locally with ``--cache-dir``), an on-disk JSONL
  cohort (``--input-path <dir>``: the same directory and CSR
  sidecar the JAX package's CLI reads) or the hermetic synthetic cohort
  (``--fixture-*`` flags). Computes on the card by default; ``--device
  cpu`` runs on the CPU; ``--mesh-shape`` lays G out over this
  process's devices, and the launcher's ``MASTER_ADDR``/``RANK``
  variables (``torchrun``) make the run data-parallel across processes;
- ``serve-cohort``: host a cohort as a Genomics-compatible HTTP service,
  and with ``--grpc-port`` as a gRPC service beside it (either package's
  client reads either); with ``--analyze``, the analysis job tier
  (``POST /analyze``, ``GET /jobs``) with its delta and gang Gramians,
  journal, durable store and replica leases, on the card unless
  ``--device cpu``; a gRPC server also serves ``ComputePca`` on the
  driver's device;
- ``pca-bridge``: the PcaBackend seam over newline-JSON TCP (``--port``,
  default 18717): an external driver streams carrier lists and gets
  coordinates computed on the card (``--device cpu`` on the CPU);
- ``generate-fixture``: write a synthetic JSONL cohort, with reads
  (``--fixture-reads``) or a tumor/normal pair of readsets
  (``--fixture-tumor-normal``) beside the variants;
- ``search-variants-klotho`` / ``search-variants-brca1``;
- ``reads-example --example 1..4``: the reference's SearchReadsExample
  drivers (pileup, coverage, per-base depth, tumor/normal diff), and
  ``pairhmm``: every read scored against its consensus haplotype. Reads
  come from the fixture (``--fixture-reads``), ``--input-path`` or
  ``--api-url``; examples 3 and 4 and ``pairhmm`` compute on the card
  unless ``--device cpu`` is given.

``--trace-out/--metrics-out/--manifest-out`` open one telemetry session
around the command, and ``--fault-plan`` installs a fault plan for it.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    FIXTURE_READSET_ID,
    NORMAL_READSET_ID,
    TUMOR_READSET_ID,
    synthetic_cohort,
    synthetic_reads,
    synthetic_tumor_normal,
)
from spark_examples_tpu_torch.genomics.shards import (
    BRCA1_REFERENCES,
    KLOTHO_REFERENCES,
    references_for_all,
)
from spark_examples_tpu_torch.genomics.sources import JsonlSource
from spark_examples_tpu_torch.utils.config import (
    add_analyze_flags,
    add_pca_flags,
    pca_config_from_args,
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


def _network_source(args):
    """HTTP or gRPC source with credentials — the Client(auth)
    construction.

    Resolves the credential once via get_access_token (the
    Authentication.getAccessToken analog, Client.scala:29-46) and ships it
    on every per-shard request, under one retry policy and one breaker
    configuration. ``--cache-dir``/``--mirror-mode``/``--cold-stream``
    drive the shared cohort mirror on either transport.
    """
    from spark_examples_tpu_torch.genomics.auth import get_access_token
    from spark_examples_tpu_torch.genomics.service import HttpVariantSource
    from spark_examples_tpu_torch.resilience import BreakerSet, RetryPolicy

    retry_policy = RetryPolicy(
        max_attempts=max(1, args.rpc_retries),
        deadline=args.rpc_retry_deadline,
    )

    def breakers(prefix: str) -> BreakerSet:
        return BreakerSet(
            prefix,
            failure_threshold=args.breaker_threshold,
            cooldown_s=args.breaker_cooldown,
        )

    mirror = dict(
        cache_dir=args.cache_dir,
        mirror_mode=args.mirror_mode,
        cold_stream=args.cold_stream,
    )
    if args.api_url.startswith("grpc://"):
        # The HTTP/2 server-streaming transport (the reference's bulk
        # channel technology, VariantsRDD.scala:26,210-211).
        from spark_examples_tpu_torch.genomics.grpc_transport import (
            GrpcVariantSource,
            grpc_available,
        )

        if not grpc_available():
            raise SystemExit(
                "grpc:// transport needs grpcio (pip install "
                "'spark_examples_tpu[grpc]'); the http:// transport "
                "has no extra dependency"
            )
        return GrpcVariantSource(
            args.api_url,
            credentials=get_access_token(args.client_secrets),
            idle_timeout=args.grpc_idle_timeout or None,
            retry_policy=retry_policy,
            breakers=breakers(f"grpc:{args.api_url}:"),
            **mirror,
        )
    return HttpVariantSource(
        args.api_url,
        credentials=get_access_token(args.client_secrets),
        retry_policy=retry_policy,
        breakers=breakers(f"http:{args.api_url}:"),
        **mirror,
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


def _resolve_source(args, references: str):
    # Offline sources (fixture/JSONL) never consume credentials or the
    # mirror options; --client-secrets, --cache-dir and --mirror-mode
    # apply to the network source only.
    if args.api_url:
        return _network_source(args)
    source = _offline_source(args, references)
    if source is None:
        raise SystemExit(
            "No data source: pass --api-url <service>, --input-path "
            "<jsonl cohort dir>, or --fixture-samples N (the Genomics v1 "
            "API is retired; serve-cohort hosts a compatible service)"
        )
    return source


def _mesh(args):
    """The mesh ``--mesh-shape`` names, on ``--device`` (None without
    one)."""
    if not args.mesh_shape:
        return None
    from spark_examples_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(args.mesh_shape, device=args.device)


def _cmd_pca(args) -> int:
    from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
    from spark_examples_tpu_torch.parallel.distributed import (
        initialize_from_env,
    )

    # Joins the process group when the launcher's variables are set.
    initialize_from_env(args.device)
    conf = pca_config_from_args(args)
    if not args.variant_set_ids:
        conf.variant_set_ids = [DEFAULT_VARIANT_SET_ID]
    source = _resolve_source(
        args,
        # Cover exactly what an --all-references manifest queries.
        references_for_all() if conf.all_references else conf.references,
    )
    VariantsPcaDriver(conf, source, mesh=_mesh(args)).run()
    return 0


def _cmd_generate_fixture(args) -> int:
    """Write a JSONL cohort directory for offline runs."""
    src = synthetic_cohort(
        args.fixture_samples or 100,
        args.fixture_variants,
        references=args.references,
        seed=args.fixture_seed,
        sparse_calls=args.fixture_sparse_calls,
        rare_variant_af=args.fixture_rare_af,
        variant_set_id=(args.variant_set_ids or [DEFAULT_VARIANT_SET_ID])[0],
    )
    if args.fixture_tumor_normal:
        # Tumor/normal pair for reads-example 4.
        pair = synthetic_tumor_normal(
            args.fixture_tumor_normal,
            references=args.reads_references or "1:100000000:100002000",
            seed=args.fixture_seed,
        )
        src.add_reads(pair.reads_records())
    elif args.fixture_reads:
        # Same directory serves reads examples 1-3 via --input-path; the
        # region must cover the example's query window
        # (--reads-references defaults to --references).
        reads_src = synthetic_reads(
            args.fixture_reads,
            references=args.reads_references or args.references,
            seed=args.fixture_seed,
        )
        src.add_reads(reads_src.reads_records())
    src.dump(args.out)
    print(f"Wrote cohort to {args.out}")
    return 0


def _resolve_reads_source(args, references: str):
    """Returns (source, read_group_set_id)."""
    if args.api_url:
        return _network_source(args), (args.read_group_set_id or "")
    if args.input_path:
        # Local cohorts default to no readset filter (serve whatever the
        # directory holds); --read-group-set-id narrows it.
        return JsonlSource(args.input_path), (args.read_group_set_id or "")
    if args.fixture_reads:
        return (
            synthetic_reads(
                args.fixture_reads,
                references=references,
                seed=args.fixture_seed,
            ),
            FIXTURE_READSET_ID,
        )
    raise SystemExit(
        "No reads source: pass --input-path <jsonl cohort dir> or "
        "--fixture-reads N"
    )


def _cmd_search_variants(args, fn) -> int:
    conf = pca_config_from_args(args)
    if not args.variant_set_ids:
        conf.variant_set_ids = [DEFAULT_VARIANT_SET_ID]
    source = _resolve_source(args, args.references)
    fn(
        source,
        variant_set_id=conf.variant_set_ids[0],
        references=args.references,
        bases_per_shard=conf.bases_per_partition,
    )
    return 0


def _cmd_reads_example(args) -> int:
    from spark_examples_tpu_torch.models import search_reads as sr

    n = args.example
    if n == 1:
        refs = args.references or (
            f"11:{sr.Examples.CILANTRO - 1000}:{sr.Examples.CILANTRO + 1000}"
        )
        source, rgsid = _resolve_reads_source(args, refs)
        for line in sr.pileup(
            source,
            rgsid,
            references=refs,
            bases_per_shard=args.bases_per_partition,
        ):
            print(line)
    elif n == 2:
        refs = args.references  # None → whole chr21, reference behavior
        source, rgsid = _resolve_reads_source(args, refs or "21:1:48129895")
        sr.average_coverage(
            source,
            rgsid,
            references=refs,
            bases_per_shard=args.bases_per_partition,
        )
    elif n == 3:
        refs = args.references
        source, rgsid = _resolve_reads_source(args, refs or "21:1:48129895")
        out = sr.per_base_depth_example(
            source,
            rgsid,
            references=refs,
            out_path=args.output_path or ".",
            bases_per_shard=args.bases_per_partition,
            device=args.device,
        )
        print(f"Wrote {out}")
    else:  # argparse limits --example to 1..4
        refs = args.references or "1:100000000:101000000"
        if args.api_url:
            source = _network_source(args)
            normal_id = args.normal_id or NORMAL_READSET_ID
            tumor_id = args.tumor_id or TUMOR_READSET_ID
        elif args.input_path:
            source = JsonlSource(args.input_path)
            # Local cohorts default to the fixture pair ids (the DREAM API
            # ids remain available via the flags).
            normal_id = args.normal_id or NORMAL_READSET_ID
            tumor_id = args.tumor_id or TUMOR_READSET_ID
        elif args.fixture_reads:
            source = synthetic_tumor_normal(
                args.fixture_reads, references=refs, seed=args.fixture_seed
            )
            normal_id, tumor_id = NORMAL_READSET_ID, TUMOR_READSET_ID
        else:
            raise SystemExit(
                "No reads source: pass --api-url, --input-path, or "
                "--fixture-reads N"
            )
        out = sr.tumor_normal_diff(
            source,
            normal_id=normal_id,
            tumor_id=tumor_id,
            references=refs,
            out_path=args.output_path or ".",
            bases_per_shard=args.bases_per_partition,
            device=args.device,
        )
        print(f"Wrote {out}")
    stats = getattr(source, "stats", None)
    if stats is not None and stats.reads_read == 0:
        print(
            "WARNING: no reads matched the queried region/readset — check "
            "that the cohort covers the example's region (--references) "
            "and readset id (--read-group-set-id / --normal-id/--tumor-id)",
            file=sys.stderr,
        )
    return 0


def _cmd_pairhmm(args) -> int:
    """The reads-side pipeline: batched PairHMM scoring."""
    from spark_examples_tpu_torch.models.pairhmm import PairHmmDriver

    conf = pca_config_from_args(args)
    # Default region = synthetic_reads' default window, so a bare
    # `pairhmm --fixture-reads N` scores out of the box (the same
    # default-region discipline as the reads examples).
    conf.references = args.references or "11:6888648:6890648"
    source, rgsid = _resolve_reads_source(args, conf.references)
    if not conf.read_group_set_id:
        conf.read_group_set_id = rgsid
    PairHmmDriver(conf, source).run(out_path=args.output_path)
    return 0


def _cmd_pca_bridge(args) -> int:
    """Serve the PcaBackend seam over TCP."""
    from spark_examples_tpu_torch.bridge import (
        PcaBridgeServer,
        TorchPcaBackend,
    )

    server = PcaBridgeServer(
        TorchPcaBackend(
            mesh=_mesh(args),
            block_variants=args.block_variants,
            device=args.device,
        ),
        port=args.port,
    ).start()
    print(f"PcaBackend bridge listening on 127.0.0.1:{server.port}",
          flush=True)
    try:
        import threading

        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()
    return 0


def _analysis_tier(args, source):
    """The --analyze job tier: re-entrant PCA engine over the served
    source (on the card unless --device cpu) + bounded admission +
    crash-safe journal (serving/)."""
    from spark_examples_tpu_torch.serving import (
        DEFAULT_HEARTBEAT_S,
        DEFAULT_LEASE_TTL_S,
        AnalysisEngine,
        AnalysisJobTier,
        LeaseManager,
    )

    _REPLICA_FLAG_DEFAULTS = {
        "--replica-id": None,
        "--replica-lease-ttl": DEFAULT_LEASE_TTL_S,
        "--replica-heartbeat": DEFAULT_HEARTBEAT_S,
    }

    # Loud validation before any work, like every other flag surface
    # (--prefetch-depth/--ingest-workers discipline): a zero-worker
    # tier would accept jobs and never run them.
    for flag, value in (
        ("--analyze-workers", args.analyze_workers),
        ("--analyze-queue-depth", args.analyze_queue_depth),
        ("--analyze-tenant-quota", args.analyze_tenant_quota),
        ("--analyze-cache-size", args.analyze_cache_size),
    ):
        if value < 1:
            raise SystemExit(f"{flag} must be >= 1, got {value}")
    for flag, value in (
        ("--delta-max-samples", args.delta_max_samples),
        ("--gang-max-samples", args.gang_max_samples),
    ):
        if value < 0:
            raise SystemExit(
                f"{flag} must be >= 0 (0 disables), got {value}"
            )
    if args.store_dir is None:
        # --replica-* only mean something over a shared store; a
        # silently ignored flag is how operators think they deployed
        # failover and discover otherwise during an outage.
        for flag, value in (
            ("--replica-id", args.replica_id),
            ("--replica-lease-ttl", args.replica_lease_ttl),
            ("--replica-heartbeat", args.replica_heartbeat),
        ):
            if value is not None and value != _REPLICA_FLAG_DEFAULTS[flag]:
                raise SystemExit(
                    f"{flag} requires --store-dir (replicated serving "
                    "needs a shared durable store)"
                )
    else:
        if args.replica_lease_ttl <= 0:
            raise SystemExit(
                "--replica-lease-ttl must be > 0, got "
                f"{args.replica_lease_ttl}"
            )
        if not 0 < args.replica_heartbeat < args.replica_lease_ttl:
            raise SystemExit(
                "--replica-heartbeat must satisfy 0 < heartbeat < "
                f"lease ttl ({args.replica_lease_ttl}), got "
                f"{args.replica_heartbeat}"
            )
    mesh = _mesh(args)
    base = pca_config_from_args(args)
    if not args.variant_set_ids:
        base.variant_set_ids = [DEFAULT_VARIANT_SET_ID]
    if not args.analyze_journal_dir and not args.store_dir:
        print(
            "WARNING: --analyze without --analyze-journal-dir: jobs are "
            "in-memory only and a crash forgets them all.",
            file=sys.stderr,
        )
    import os

    replica = None
    delta_fence = None
    if args.store_dir:
        from spark_examples_tpu_torch.store import LocalDirStore

        replica = LeaseManager(
            LocalDirStore(args.store_dir),
            replica_id=args.replica_id,
            ttl_s=args.replica_lease_ttl,
            heartbeat_s=args.replica_heartbeat,
        )
        if not replica.start():
            # Degraded from birth (store unreachable): the tier still
            # comes up — single-replica local mode, journal/ckpt on
            # local disk, serving_store_degraded=1. Restart with a
            # reachable store to rejoin the replica set.
            print(
                "WARNING: --store-dir unreachable at startup; serving "
                "single-replica local (restart with a reachable store "
                "to rejoin the replica set).",
                file=sys.stderr,
            )
        delta_fence = replica.check_fence
    # The delta cache persists beside the journal — or, replicated, in
    # the shared store so a warm delta computed on one replica answers
    # on all: a kill -9'd server restarted on the same directory
    # answers ±k cohort deltas warm (checksummed write-through; torn
    # entries drop loudly to cold on re-load).
    if args.store_dir and args.delta_max_samples > 0:
        delta_persist = os.path.join(args.store_dir, "deltas")
    elif args.analyze_journal_dir and args.delta_max_samples > 0:
        delta_persist = os.path.join(args.analyze_journal_dir, "deltas")
    else:
        delta_persist = None
    tier = AnalysisJobTier(
        AnalysisEngine(
            source,
            mesh=mesh,
            delta_max_samples=args.delta_max_samples,
            delta_persist_dir=delta_persist,
            delta_fence=delta_fence,
            device=args.device,
        ),
        base,
        queue_depth=args.analyze_queue_depth,
        tenant_quota=args.analyze_tenant_quota,
        workers=args.analyze_workers,
        journal_dir=args.analyze_journal_dir,
        cache_size=args.analyze_cache_size,
        gang_max_samples=args.gang_max_samples,
        replica=replica,
    )
    return tier.start()


def _cmd_serve_cohort(args) -> int:
    """Host a cohort as a Genomics-compatible HTTP service (and, with
    ``--grpc-port``, a gRPC service on the same source); with
    ``--analyze``, the analysis job tier behind ``POST /analyze``."""
    import os

    from spark_examples_tpu_torch.genomics.service import (
        GenomicsServiceServer,
    )

    source = _offline_source(args, args.references)
    if source is None:
        raise SystemExit(
            "serve-cohort needs --input-path <jsonl dir> or "
            "--fixture-samples N"
        )
    warm = getattr(source, "ensure_serving_index", None)
    if warm is not None:
        # Index BEFORE accepting requests: a lazy build on the first
        # shard request of a large cohort outlives client socket timeouts.
        print("Indexing cohort for serving ...", flush=True)
        print(f"Indexed {warm()} variant records.", flush=True)
    grpc_server = None
    job_tier = None
    stack = contextlib.ExitStack()
    try:
        if args.grpc_port is not None:
            from spark_examples_tpu_torch.genomics.grpc_transport import (
                GrpcGenomicsServer,
                grpc_available,
            )

            if not grpc_available():
                raise SystemExit(
                    "--grpc-port needs grpcio (pip install "
                    "'spark_examples_tpu[grpc]'); omit it to serve HTTP "
                    "only"
                )
            from spark_examples_tpu_torch.bridge.backend import (
                TorchPcaBackend,
            )

            # The gRPC endpoint also exposes the ComputePca dense-math
            # seam: external drivers stream call lists and get
            # coordinates back from this host's card (--device), with the
            # same block flag pca-bridge takes. The backend resolves its
            # device at the first ComputePca call, so serving stays
            # host-only until one arrives.
            grpc_server = GrpcGenomicsServer(
                source, port=args.grpc_port, token=args.token,
                host=args.host,
                pca_backend=TorchPcaBackend(
                    mesh=_mesh(args),
                    block_variants=args.block_variants,
                    device=args.device,
                ),
            ).start()
            _announce(
                f"gRPC stream service on grpc://{args.host}:"
                f"{grpc_server.port}"
                + (" (token auth)" if args.token else "")
            )
        if args.analyze:
            # The live introspection plane (/metrics, /statusz,
            # /jobs?trace=1) reads the ambient registry and tracer, so
            # an analysis server keeps one collection session open for
            # its whole lifetime — unless the CLI entrypoint already
            # opened one for --trace-out/--metrics-out artifacts.
            from spark_examples_tpu_torch.obs.session import (
                TelemetrySession,
            )
            from spark_examples_tpu_torch.obs.tracer import (
                collection_active,
            )

            if not collection_active():
                stack.enter_context(
                    TelemetrySession(command="serve-cohort")
                )
            if args.analyze_journal_dir:
                # Crash flight recorder rides beside the journal: the
                # last K span/metric transitions land in
                # <journal>/flightrec/ on watchdog exit-77, SIGTERM,
                # or an unhandled exception.
                from spark_examples_tpu_torch.obs import flightrec

                flightrec.install(
                    os.path.join(args.analyze_journal_dir, "flightrec")
                )
            job_tier = _analysis_tier(args, source)
            print(
                f"Analysis tier up: queue depth "
                f"{args.analyze_queue_depth}, tenant quota "
                f"{args.analyze_tenant_quota}, "
                f"{args.analyze_workers} worker(s)"
                + (
                    f", journal {args.analyze_journal_dir}"
                    if args.analyze_journal_dir
                    else " (no journal)"
                )
                + (
                    f", deltas <= {args.delta_max_samples} samples"
                    if args.delta_max_samples > 0
                    else ", deltas off"
                )
                + (
                    f", gangs <= {args.gang_max_samples} samples"
                    if args.gang_max_samples > 0
                    else ", gangs off"
                )
                + (
                    ", replica "
                    f"{job_tier.replica_health()['replica_id']} on "
                    f"store {args.store_dir} (lease ttl "
                    f"{args.replica_lease_ttl:g}s)"
                    if args.store_dir
                    else ""
                ),
                flush=True,
            )
        server = GenomicsServiceServer(
            source,
            port=args.port,
            token=args.token,
            host=args.host,
            job_tier=job_tier,
        )
        _announce(
            f"Genomics service listening on http://{args.host}:"
            f"{server.port}" + (" (token auth)" if args.token else "")
        )
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.stop()
    finally:
        # Covers HTTP bind failures too — a started gRPC server or job
        # tier must never outlive the command that printed its URL.
        if grpc_server is not None:
            grpc_server.stop()
        if job_tier is not None:
            job_tier.close()
        stack.close()
    return 0


def _announce(line: str) -> None:
    """Print a line that clients parse (a server's address) in one write:
    ``print`` writes the text and its newline separately, so a journal
    job's worker thread printing at the same moment could split the line
    in two."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="spark_examples_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    pca = sub.add_parser("pca", help="VariantsPcaDriver: PCoA over a cohort")
    add_pca_flags(pca)
    _add_fixture_flags(pca)
    pca.set_defaults(fn=_cmd_pca)

    gen = sub.add_parser(
        "generate-fixture", help="Write a synthetic JSONL cohort"
    )
    add_pca_flags(gen)
    _add_fixture_flags(gen)
    gen.add_argument("--out", required=True)
    gen.add_argument(
        "--fixture-reads",
        type=int,
        default=None,
        help="Also write reads.jsonl with this many synthetic reads",
    )
    gen.add_argument(
        "--reads-references",
        default=None,
        help="Region for generated reads (defaults to --references)",
    )
    gen.add_argument(
        "--fixture-tumor-normal",
        type=int,
        default=None,
        help="Write a tumor/normal reads pair (for reads-example 4) "
        "instead of a single readset",
    )
    gen.set_defaults(fn=_cmd_generate_fixture)

    from spark_examples_tpu_torch.models.search_variants import (
        search_variants_brca1,
        search_variants_klotho,
    )

    for name, fn, refs in (
        ("search-variants-klotho", search_variants_klotho, KLOTHO_REFERENCES),
        ("search-variants-brca1", search_variants_brca1, BRCA1_REFERENCES),
    ):
        sv = sub.add_parser(name, help=f"{name} example driver")
        add_pca_flags(sv)
        _add_fixture_flags(sv)
        sv.set_defaults(references=refs)
        sv.set_defaults(fn=lambda a, _f=fn: _cmd_search_variants(a, _f))

    reads = sub.add_parser(
        "reads-example", help="SearchReadsExample 1-4 drivers"
    )
    add_pca_flags(reads)
    _add_fixture_flags(reads)
    reads.add_argument(
        "--example", type=int, required=True, choices=[1, 2, 3, 4]
    )
    reads.add_argument(
        "--fixture-reads",
        type=int,
        default=None,
        help="Run against synthetic reads",
    )
    reads.add_argument("--normal-id", default=None)
    reads.add_argument("--tumor-id", default=None)
    reads.set_defaults(references=None, fn=_cmd_reads_example)

    phmm = sub.add_parser(
        "pairhmm",
        help="Score every read against its consensus haplotype with "
        "the batched PairHMM forward pass",
    )
    add_pca_flags(phmm)
    _add_fixture_flags(phmm)
    phmm.add_argument(
        "--fixture-reads",
        type=int,
        default=None,
        help="Run against synthetic reads",
    )
    phmm.set_defaults(references=None, fn=_cmd_pairhmm)

    bridge = sub.add_parser(
        "pca-bridge", help="Serve the PcaBackend seam over TCP"
    )
    add_pca_flags(bridge)
    bridge.add_argument("--port", type=int, default=18717)
    bridge.set_defaults(fn=_cmd_pca_bridge)

    serve = sub.add_parser(
        "serve-cohort",
        help="Host a cohort as a Genomics-compatible HTTP service",
    )
    add_pca_flags(serve)
    _add_fixture_flags(serve)
    add_analyze_flags(serve)
    serve.add_argument("--port", type=int, default=18718)
    serve.add_argument(
        "--grpc-port",
        type=int,
        default=None,
        help="Also serve the gRPC/HTTP-2 server-streaming transport on "
        "this port (0 = auto-pick; clients connect with --api-url "
        "grpc://host:port). The HTTP service keeps the mirror/cache "
        "endpoints; both front the same cohort",
    )
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument(
        "--token",
        default=None,
        help="Require this bearer token on every request",
    )
    serve.set_defaults(fn=_cmd_serve_cohort)
    return p


def main(argv=None) -> int:
    from spark_examples_tpu_torch.resilience import faults

    args = build_parser().parse_args(argv)
    # The fault plane: --fault-plan scopes a plan to this one command.
    plan = (
        faults.FaultPlan.from_spec(args.fault_plan)
        if args.fault_plan
        else None
    )
    with faults.active_plan(plan) if plan else contextlib.nullcontext():
        outs = {
            name: getattr(args, name)
            for name in ("trace_out", "metrics_out", "manifest_out")
        }
        if not any(outs.values()):
            return args.fn(args)
        # One telemetry session per CLI run: spans and metrics collected
        # by the ambient helpers everywhere below, artifacts written on
        # exit — on the failure path too.
        from spark_examples_tpu_torch.obs import telemetry_session

        config = {
            k: v for k, v in sorted(vars(args).items()) if k != "fn"
        }
        with telemetry_session(
            command=args.command, config=config, **outs
        ):
            return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
