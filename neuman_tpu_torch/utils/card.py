"""The card's name and power limit, as nvidia-smi gives them."""

import subprocess


def smi_line():
    """nvidia-smi's "name, power.limit" line of the first card, or
    "nvidia-smi failed" where it does not run."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "nvidia-smi failed"
