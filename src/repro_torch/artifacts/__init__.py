"""Packed MX artifact store, in the on-disk format of
``docs/artifact-format.md`` (readable and writable by both packages)."""
from .manifest import (ArtifactError, IntegrityError, Manifest,  # noqa
                       TensorRecord, array_sha256)
from .store import (export_artifact, load_artifact,  # noqa
                    quant_mode_from_json, quant_mode_to_json, verify_artifact)
