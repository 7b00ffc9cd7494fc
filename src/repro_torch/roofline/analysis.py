"""Measured wire accounting from collective-emitted WireReports (torch port
of ``repro.roofline.analysis``, :func:`summarize_wire_reports` only).

The compressed collectives record a WireReport per wire
(``core/policy.record_wire_report``): raw vs packed wire bytes, whether the
receive side ran the FUSED decode+reduce, and the decoded-float HBM
round-trip the unfused path would incur.  ``obs/regret.check_ledger_exactness``
holds the per-bucket ledger against this summary.  The reference's HLO byte
parser and roofline model are not ported.
"""
from __future__ import annotations


def summarize_wire_reports(reports) -> dict:
    """Aggregate a sequence of WireReports into roofline-ready totals.

    Returns a dict with total raw/wire bytes, the overall compression
    ratio, the decoded-float HBM round-trip bytes still *paid* (unfused
    receives) and the bytes *eliminated* (fused receives), plus a
    per-collective-name breakdown.  ``decode_hbm_bytes`` on a report is the
    potential round-trip; the ``fused`` flag decides which bucket it lands
    in."""
    by_name: dict = {}

    def blank(name=None):
        d = {"n": 0, "raw_bytes": 0, "wire_bytes": 0,
             "decode_hbm_paid": 0, "decode_hbm_eliminated": 0, "n_fused": 0,
             "encode_hbm_paid": 0, "encode_hbm_eliminated": 0,
             "n_encode_fused": 0}
        if name is not None:
            d["name"] = name
        return d

    tot = blank()
    for r in reports:
        for d in (tot, by_name.setdefault(r.name, blank(r.name))):
            d["n"] += 1
            d["raw_bytes"] += r.raw_bytes
            d["wire_bytes"] += r.wire_bytes
            key = "decode_hbm_eliminated" if r.fused else "decode_hbm_paid"
            d[key] += r.decode_hbm_bytes
            d["n_fused"] += int(r.fused)
            ekey = ("encode_hbm_eliminated" if r.encode_fused
                    else "encode_hbm_paid")
            d[ekey] += r.encode_hbm_bytes
            d["n_encode_fused"] += int(r.encode_fused)
    tot["ratio"] = tot["wire_bytes"] / max(tot["raw_bytes"], 1)
    for d in by_name.values():
        d["ratio"] = d["wire_bytes"] / max(d["raw_bytes"], 1)
    tot["by_name"] = by_name
    return tot
