from .bgzf import BgzfReader, BgzfWriter, is_bgzf
from .bam import BamReader, BamRecord, bam_endpos
from .bam_writer import BamWriter, build_bai_index
