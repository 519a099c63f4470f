"""Drug-design datasets (reference src/drug_design/).

Copy of molchanica_tpu.drug_design."""
from .pdbbind import (Affinity, Entry, find_root, load_entries,  # noqa: F401
                      load_entry, load_index)
