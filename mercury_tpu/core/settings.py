"""INI settings tier — the reference's mercury.ini equivalent.

The reference has three config tiers (SURVEY §5): compiled defaults
(physical_config.cc / datalink_config.cc), the mercury.ini file written by
the GUI (gui/ini_parser.cc:143-330), and CLI flags, with CLI > INI >
defaults precedence (main.cc:354-403, 547-601). This module provides the
middle tier: the same sections/keys ([Station] MyCallsign/RadioType,
[Network] ControlPort/DataPort/ExitOnDisconnect, [ARQ]
GearShift/InitialConfig/RobustMode/LinkTimeout/..., [Modem]
LDPCIterationsMax/CoarseFreqSync, [PTT] OnDelayMs/OffDelayMs/PilotTone*),
minus the sound-card/GUI-window keys that have no analogue in a headless
accelerator deployment (an [Audio] Transport key replaces the device selection).
"""

from __future__ import annotations

import configparser
import os
from dataclasses import dataclass, field, fields

DEFAULT_PATHS = (
    "mercury-tpu.ini",
    os.path.expanduser("~/.config/mercury-tpu/mercury-tpu.ini"),
)


@dataclass
class Settings:
    """Typed view of the INI file. Field defaults == compiled defaults, so a
    missing file or key falls through to tier 1 automatically."""
    # [Station]
    my_callsign: str = "NOCALL"
    radio_type: str = "stockhf"        # stockhf | sbitx (carrier +15 kHz)
    # [Network]
    control_port: int = 7002
    data_port: int = 7003
    exit_on_disconnect: bool = False
    # [ARQ]
    gear_shift: bool = True
    initial_config: int = 0
    robust_mode: bool = True
    turboshift: bool = False
    wire_compat: bool = False          # stock-Mercury framing (stock peers)
    link_timeout_ms: int = 30000
    max_connection_attempts: int = 10
    batch_size: int = 5
    # [Modem]
    ldpc_iterations_max: int = 50
    coarse_freq_sync: bool = True      # maps to RxChain cfo_range wide/narrow
    rx_profile: str = "static"         # "track" = fading-tracking receiver
                                       # (decision-directed, docs/fading_r2.md)
    # [PTT]
    ptt_on_delay_ms: int = 100
    ptt_off_delay_ms: int = 200
    pilot_tone_hz: int = 0
    pilot_tone_ms: int = 0
    # [Audio] — transport replaces the reference's device/backend selection
    transport: str = ""                # e.g. "udp:127.0.0.1:5500:5501", "file:..."

    loaded_from: str | None = field(default=None, compare=False)

    _SCHEMA = {
        "Station": {"MyCallsign": "my_callsign", "RadioType": "radio_type"},
        "Network": {"ControlPort": "control_port", "DataPort": "data_port",
                    "ExitOnDisconnect": "exit_on_disconnect"},
        "ARQ": {"GearShift": "gear_shift", "InitialConfig": "initial_config",
                "RobustMode": "robust_mode", "Turboshift": "turboshift",
                "WireCompat": "wire_compat",
                "LinkTimeout": "link_timeout_ms",
                "MaxConnectionAttempts": "max_connection_attempts",
                "BatchSize": "batch_size"},
        "Modem": {"LDPCIterationsMax": "ldpc_iterations_max",
                  "CoarseFreqSync": "coarse_freq_sync",
                  "RxProfile": "rx_profile"},
        "PTT": {"OnDelayMs": "ptt_on_delay_ms", "OffDelayMs": "ptt_off_delay_ms",
                "PilotToneHz": "pilot_tone_hz", "PilotToneMs": "pilot_tone_ms"},
        "Audio": {"Transport": "transport"},
    }

    @classmethod
    def load(cls, path: str | None = None) -> "Settings":
        """Load from `path`, or the first existing default location; missing
        file returns pure defaults (loaded_from=None)."""
        s = cls()
        candidates = [path] if path else list(DEFAULT_PATHS)
        for p in candidates:
            if p and os.path.isfile(p):
                cp = configparser.ConfigParser()
                cp.read(p)
                types = {f.name: f.type for f in fields(cls)}
                for section, keys in cls._SCHEMA.items():
                    if not cp.has_section(section):
                        continue
                    for ini_key, attr in keys.items():
                        if not cp.has_option(section, ini_key):
                            continue
                        t = types[attr]
                        if t == "bool":
                            setattr(s, attr, cp.getboolean(section, ini_key))
                        elif t == "int":
                            setattr(s, attr, cp.getint(section, ini_key))
                        else:
                            setattr(s, attr, cp.get(section, ini_key))
                s.loaded_from = p
                break
        return s

    def save(self, path: str) -> None:
        cp = configparser.ConfigParser()
        for section, keys in self._SCHEMA.items():
            cp.add_section(section)
            for ini_key, attr in keys.items():
                v = getattr(self, attr)
                cp.set(section, ini_key,
                       ("true" if v else "false") if isinstance(v, bool)
                       else str(v))
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            cp.write(f)

    def arq_config(self):
        """Build an ArqConfig from this tier (CLI overrides applied by the
        caller beforehand)."""
        from mercury_tpu.link.node import ArqConfig
        return ArqConfig(init_configuration=self.initial_config,
                         gear_shift_on=self.gear_shift,
                         robust_enabled=self.robust_mode,
                         turboshift=self.turboshift,
                         batch_size=self.batch_size,
                         link_timeout_ms=self.link_timeout_ms,
                         ptt_on_delay_ms=self.ptt_on_delay_ms,
                         ptt_off_delay_ms=self.ptt_off_delay_ms,
                         rx_profile=self.rx_profile,
                         wire_compat=self.wire_compat,
                         ldpc_max_iter=self.ldpc_iterations_max,
                         carrier_offset_hz=(15000.0 if self.radio_type
                                            == "sbitx" else 0.0))
