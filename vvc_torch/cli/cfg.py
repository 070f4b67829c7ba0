"""Configuration system: VTM-style cfg files + CLI options.

Port of vvc/cli/cfg.py (a copy, imports rewritten).  Analog of the
reference's option machinery
(`VTM/source/Lib/Utilities/program_options_lite.cpp` →
df::program_options_lite (Key: Value files, --Key=Value CLI, nested -c
includes) and `source/App/EncoderApp/EncAppCfg.cpp` → parseCfg mapping
~900 options).  Per SURVEY.md §5.6, options compile into frozen parameter
sets (vvc_torch.hls.ps) and runtime code consults only those.

The reference's CTC cfg files (encoder_intra_vtm.cfg etc.) parse directly:
unknown keys are collected, not fatal, so the full CTC corpus loads while
tools land incrementally.
"""
from __future__ import annotations


def parse_cfg_file(path: str) -> dict:
    """Parse a VTM-style `Key : Value  # comment` file."""
    out = {}
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            if ":" not in line:
                continue
            key, val = line.split(":", 1)
            out[key.strip()] = val.strip()
    return out


def parse_args(argv: list) -> dict:
    """CLI: -c file.cfg (repeatable, later wins), --Key=Value, -i/-o/-b/-q
    short options mirroring the reference apps."""
    opts: dict = {}
    short = {"-i": "InputFile", "-o": "ReconFile", "-b": "BitstreamFile",
             "-q": "QP", "-f": "FramesToBeEncoded", "-wdt": "SourceWidth",
             "-hgt": "SourceHeight", "-fr": "FrameRate"}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-c":
            i += 1
            opts.update(parse_cfg_file(argv[i]))
        elif a.startswith("--") and "=" in a:
            k, v = a[2:].split("=", 1)
            opts[k] = v
        elif a in short:
            i += 1
            opts[short[a]] = argv[i]
        else:
            raise SystemExit(f"unknown option {a}")
        i += 1
    return opts


_TRUE = {"1", "true", "yes", "on"}


def as_bool(v, default=False) -> bool:
    if v is None:
        return default
    return str(v).strip().lower() in _TRUE


def as_int(v, default=0) -> int:
    if v is None:
        return default
    return int(str(v).strip())


# keys the round-1 encoder consumes; everything else is carried through and
# reported once (EncAppCfg parity tracking)
SUPPORTED_KEYS = {
    "InputFile", "BitstreamFile", "ReconFile", "SourceWidth", "SourceHeight",
    "InputBitDepth", "InternalBitDepth", "FramesToBeEncoded", "FrameRate",
    "FrameSkip", "QP", "CTUSize", "IntraPeriod", "DecodingRefreshType",
    "GOPSize", "Profile", "Level", "RateControl", "TargetBitrate",
    "DepQuant", "TemporalFilter", "BIO", "DMVR",
    "Affine", "MMVD", "CIIP", "Geo", "MRL", "IMV", "SMVD", "BCW",
    "NumTileColumns", "NumTileRows", "WaveFrontSynchro", "LMCSEnable", "SAO", "ALF",
    "CostMode", "MTS", "LFNST", "MIP", "ISP", "MaxMTTHierarchyDepth",
    "MaxMTTHierarchyDepthISliceL", "TraceFile", "TraceRule",
}


def build_encoder_config(opts: dict):
    """opts → (SPS, PPS, io dict, leftover keys)."""
    from vvc_torch.hls.ps import SPS, PPS

    w = as_int(opts.get("SourceWidth"))
    h = as_int(opts.get("SourceHeight"))
    bd = as_int(opts.get("InputBitDepth"), 8)
    ctu = as_int(opts.get("CTUSize"), 64)
    if ctu > 64:
        ctu = 64  # round-1 cap; 128 lands with the MTT stage [verify]
    lossless = (str(opts.get("CostMode", "")).strip().lower() == "lossless")
    sps = SPS(width=w, height=h, bit_depth=bd, ctu_size=ctu,
              lossless=lossless,
              lmcs=as_bool(opts.get("LMCSEnable")),
              sao=as_bool(opts.get("SAO"), True),
              alf=as_bool(opts.get("ALF"), True),
              mts_intra=as_bool(opts.get("MTS"), True),
              lfnst=as_bool(opts.get("LFNST"), True),
              mip=as_bool(opts.get("MIP"), True))
    pps = PPS(init_qp=as_int(opts.get("QP"), 32),
              num_tile_cols=as_int(opts.get("NumTileColumns"), 1),
              num_tile_rows=as_int(opts.get("NumTileRows"), 1),
              wpp=as_bool(opts.get("WaveFrontSynchro")))
    if as_bool(opts.get("RateControl")) and as_int(opts.get("TargetBitrate")) <= 0:
        raise SystemExit("RateControl enabled but TargetBitrate missing/zero")
    # GOP shape from IntraPeriod/GOPSize (reference: EncAppCfg GOP table
    # selection): IntraPeriod 1 → AI; IntraPeriod > 1 → random access;
    # IntraPeriod <= 0 with GOPSize → low delay
    ip = as_int(opts.get("IntraPeriod"), 1)
    gop_size = as_int(opts.get("GOPSize"), 16)
    if ip == 1:
        mode = "ai"
    elif ip > 1:
        mode = "ra"
    else:
        mode = "ldp"
    io = {
        "input": opts.get("InputFile"),
        "bitstream": opts.get("BitstreamFile", "out.266"),
        "recon": opts.get("ReconFile"),
        "frames": as_int(opts.get("FramesToBeEncoded"), 0),
        "skip": as_int(opts.get("FrameSkip"), 0),
        "fps": as_int(opts.get("FrameRate"), 30),
        "mode": mode,
        "gop_size": gop_size,
        "intra_period": ip,
        # RateControl + TargetBitrate (bps, reference option units)
        "target_kbps": (as_int(opts.get("TargetBitrate")) / 1000.0
                        if as_bool(opts.get("RateControl")) else 0.0),
        "dep_quant": as_bool(opts.get("DepQuant")),
        "isp": as_bool(opts.get("ISP")),
        "mtt": (as_int(opts.get("MaxMTTHierarchyDepthISliceL"),
                       as_int(opts.get("MaxMTTHierarchyDepth"), 0)) > 0),
        "mctf": as_bool(opts.get("TemporalFilter")),
        "bdof": as_bool(opts.get("BIO")),
        "dmvr": as_bool(opts.get("DMVR")),
        "affine": as_bool(opts.get("Affine")),
        "mmvd": as_bool(opts.get("MMVD")),
        "ciip": as_bool(opts.get("CIIP")),
        "gpm": as_bool(opts.get("Geo")),
        "mrl": as_bool(opts.get("MRL")),
        "amvr": as_bool(opts.get("IMV")),
        "smvd": as_bool(opts.get("SMVD")),
        "bcw": as_bool(opts.get("BCW")),
        "num_tile_cols": pps.num_tile_cols,
        "num_tile_rows": pps.num_tile_rows,
        "wpp": pps.wpp,
        "lossless": lossless,
        "lmcs": sps.lmcs,
        "trace_file": opts.get("TraceFile"),
    }
    leftover = {k: v for k, v in opts.items() if k not in SUPPORTED_KEYS}
    return sps, pps, io, leftover
