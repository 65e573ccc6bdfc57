from .log import log_info, log_warn, log_err, log_dbg, Get_T, Get_U, set_verbose, get_verbose
