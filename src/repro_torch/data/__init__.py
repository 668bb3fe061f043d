from repro_torch.data.partition import (paper_table3, paper_table4,
                                        partition_by_batches,
                                        dirichlet_partition)
from repro_torch.data.synthetic import (make_classification_set,
                                        make_token_stream)
