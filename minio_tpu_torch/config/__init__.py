"""The config subsystem of the port, its copy of minio_tpu/config: the 20
subsystems' KV sets with the lookup order env > stored > default, and
the sealed blob with its history under `.minio.sys/config/`.
"""

from .config import HELP, KVS, SUBSYSTEMS, Config, ConfigSys

__all__ = ["KVS", "Config", "ConfigSys", "HELP", "SUBSYSTEMS"]
