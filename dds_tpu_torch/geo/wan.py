"""WAN link profiles for ChaosNet: named presets and `[chaos.profiles]`
(copy of `dds_tpu/geo/wan.py`).

A profile names the fault parameters of one DIRECTED region pair
("eu->us"); "eu<->us" installs both directions. Values are either a
preset name or a spec table with explicit parameters:

    [chaos.profiles]
    "eu<->us" = "wan-100"

    [chaos.profiles."us->ap"]
    delay-ms = 120
    jitter-ms = 18
    drop = 0.01

Presets model one-way delay as RTT/2 with ~10 % of the RTT as jitter.
`scale` shrinks every delay uniformly, so a test runs the same topology
at scale = 0.02 with the schedule's shape (who waits on whom) kept.
"""

from __future__ import annotations

from dds_tpu_torch.core.chaos import LinkFaults

# name -> round-trip seconds for a cross-region pair
WAN_PRESETS: dict[str, float] = {
    "wan-100": 0.100,
    "wan-200": 0.200,
    "wan-300": 0.300,
}


def preset_faults(name: str, scale: float = 1.0) -> LinkFaults:
    rtt = WAN_PRESETS.get(name)
    if rtt is None:
        raise ValueError(f"unknown WAN preset {name!r} "
                         f"(have {sorted(WAN_PRESETS)})")
    one_way = rtt / 2.0 * scale
    return LinkFaults(delay=one_way, jitter=one_way * 0.2)


def faults_from_spec(spec, scale: float = 1.0) -> LinkFaults:
    """A LinkFaults from a preset name or a `[chaos.profiles.*]` table.
    Delay and jitter accept ms keys or plain seconds."""
    if isinstance(spec, str):
        return preset_faults(spec, scale)
    if not isinstance(spec, dict):
        raise ValueError(f"malformed link profile {spec!r}")
    known = {"preset", "delay", "jitter", "delay-ms", "delay_ms",
             "jitter-ms", "jitter_ms", "drop", "duplicate", "reorder",
             "corrupt"}
    unknown = set(spec) - known
    if unknown:
        raise ValueError(f"unknown link-profile keys {sorted(unknown)}")
    base = preset_faults(spec["preset"], scale) if "preset" in spec else LinkFaults()

    def seconds(key: str, default: float) -> float:
        ms = spec.get(f"{key}-ms", spec.get(f"{key}_ms"))
        if ms is not None:
            return float(ms) / 1e3 * scale
        if key in spec:
            return float(spec[key]) * scale
        return default

    return LinkFaults(
        delay=seconds("delay", base.delay),
        jitter=seconds("jitter", base.jitter),
        drop=float(spec.get("drop", base.drop)),
        duplicate=float(spec.get("duplicate", base.duplicate)),
        reorder=float(spec.get("reorder", base.reorder)),
        corrupt=float(spec.get("corrupt", base.corrupt)),
    )


def parse_profiles(profiles: dict, scale: float = 1.0) -> dict:
    """`[chaos.profiles]` -> {(src_region, dst_region): LinkFaults}."""
    out: dict = {}
    for pair, spec in profiles.items():
        faults = faults_from_spec(spec, scale)
        if "<->" in pair:
            src, dst = (p.strip() for p in pair.split("<->", 1))
            out[(src, dst)] = faults
            out[(dst, src)] = faults
        elif "->" in pair:
            src, dst = (p.strip() for p in pair.split("->", 1))
            out[(src, dst)] = faults
        else:
            raise ValueError(
                f"link-profile key {pair!r} must be 'src->dst' or 'a<->b'")
    return out


def apply_profiles(net, profiles: dict, regions: dict | None = None,
                   scale: float = 1.0) -> None:
    """Install `[chaos.profiles]` onto a ChaosNet (assigning `regions`,
    endpoint name -> region, first when given). Links key on region
    names and resolve per send, so endpoints labelled later pick them
    up."""
    if regions:
        net.set_regions(regions)
    for (src, dst), faults in parse_profiles(profiles, scale).items():
        net.set_region_link(src, dst, faults)


def mesh(regions: list[str], preset: str = "wan-100") -> dict:
    """A full symmetric cross-region profile dict (intra-region links stay
    at the fabric default)."""
    return {f"{a}<->{b}": preset
            for i, a in enumerate(regions) for b in regions[i + 1:]}
