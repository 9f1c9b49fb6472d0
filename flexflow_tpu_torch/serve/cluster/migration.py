"""Prefill→decode KV page migration (disaggregated serving; the JAX
package's ``serve/cluster/migration.py`` over the port's engine).

Under disaggregation (``ServingConfig.prefill_replicas`` /
``decode_replicas``) a request prefills on a prefill-pool replica and
decodes on a decode-pool replica. The hand-off ships the PAGES, not the
prompt: the prefilled K/V already exists page-granular in the source
pool, and re-prefilling on the decode side would pay the prompt's
compute again.

The hand-off point is the chunked-prefill boundary: the prefill-final
mixed step writes the last prompt lines AND samples the first output
token, so the source replica runs the request with ``max_new_tokens=1``
— its completion IS the boundary — and what migrates is the pages
covering lines ``[0, prompt_len)`` plus the first sampled token. The
destination adopts the request straight into DECODING
(``RequestManager.adopt_prefilled``); its next step is bit for bit the
step the source would have run.

Byte-exactness: pages move through the host tier's hooks —
``engine.fetch_page`` (a clone of the page on the engine's stream, then
a copy to pinned host buffers on a side stream), the one blocking wait
(``PageSpill.host_values``), then ``engine.upload_page`` — which carry
codes, quantized scale rows and the generic decoder's position lines
exactly. A partial tail page's scale rows migrate with it, so the
destination's rescale-on-growth continues the source's scale history and
disaggregated generation is bitwise the single-replica path's over fp,
int8 and int4 pools. The wait runs at the prefill→decode boundary,
outside every decode loop: the source's pipeline is drained (the request
completed) and the destination has not seen the request yet.
"""
from __future__ import annotations

from typing import Optional

from ...logging_utils import get_logger
from ...metrics import ClusterStats
from ..request_manager import RequestStatus

_log = get_logger("serve")


def migrate_request(
    src,
    dst,
    rid: int,
    gen,
    *,
    stats: Optional[ClusterStats] = None,
    injector=None,
    trace_id: Optional[int] = None,
    tracer=None,
) -> Optional[int]:
    """Move a prefilled request from replica ``src`` to replica ``dst``.

    ``rid`` must be COMPLETED on ``src`` (the ``max_new_tokens=1``
    prefill pass) with its slot HELD (``hold_on_finish``) and no
    dispatches in flight. ``gen`` is the generation config the decode
    side runs. Returns the request id on ``dst`` — adopted into DECODING
    with the migrated pages — or None when ``dst`` has no slot or pages
    right now (nothing moved; the source keeps holding).

    Transactional: an exception during the page hand-off rolls the
    destination's adoption back (``RequestManager.rollback_adopt``) and
    re-raises; the source still holds the request with its pages, so the
    caller can retry or fall back to recompute re-admission with nothing
    leaked on either side. ``injector`` (faults.py) is consulted FIRST,
    before any adoption."""
    if injector is not None:
        injector.migration_fault(src)  # may raise InjectedMigrationFault
    req = src.rm.requests[rid]
    assert req.status is RequestStatus.COMPLETED, (
        f"migrating request {rid} in state {req.status}")
    assert req.pipeline_refs == 0, "migration with dispatches in flight"
    assert req.slot >= 0, "migration source slot already released"
    src_eng, dst_eng = src.engine, dst.engine
    assert src_eng.pager.page_size == dst_eng.pager.page_size, (
        "prefill and decode pools disagree on page_size")
    prompt_len = req.prompt_len
    rid_dst = dst.rm.adopt_prefilled(req.tokens, prompt_len, gen, profile=req.profile,
                                     prompt_text=req.prompt, trace_id=trace_id)
    if rid_dst is None:
        return None
    try:
        n_pages = src_eng.pager.pages_for(prompt_len)
        src_row = src_eng.pager.table[req.slot]
        dst_row = dst_eng.pager.table[dst.rm.requests[rid_dst].slot]
        # every page's copy starts before the one wait, then the uploads
        # (on the destination engine's stream, ordered before its steps)
        handles = [src_eng.fetch_page(int(src_row[j])) for j in range(n_pages)]
        for j, h in enumerate(handles):
            dst_eng.upload_page(int(dst_row[j]), h.host_values())
    except Exception:
        dst.rm.rollback_adopt(rid_dst)
        raise
    bytes_moved = dst_eng.page_host_bytes() * n_pages
    if stats is not None:
        stats.migrations += 1
        stats.migrated_pages += n_pages
        stats.migrated_bytes += bytes_moved
    if tracer is not None and tracer.enabled:
        tracer.event("migrate", trace_id=-1 if trace_id is None else trace_id,
                     src=src.index, dst=dst.index, pages=n_pages, bytes=bytes_moved)
    _log.debug("migrate: request %d replica %d -> %d (%d pages, %d bytes, prompt %d "
               "tokens)", rid, src.index, dst.index, n_pages, bytes_moved, prompt_len)
    return rid_dst
